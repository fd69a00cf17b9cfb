// Streamed epsilon-scaled Jacobi auction: the whole LAP solve in one launch
// at sizes where the benefit matrix no longer sits near the cores.
//
// Replaces reart_tpu/ops/pallas_auction.py: auction_solve_resident_hbm /
// _resident_hbm_kernel. Same contract as auction.cu: for benefit (B, N, M)
// float32 with N <= M and prices (B, M), each epsilon phase of eps[0..n_eps)
// (high to low) restarts from no owners and sweeps until all N rows own a
// column or max_sweeps is reached; in a sweep every row without a column
// bids (v1 - v2) + eps on its best column of v = benefit - price (lowest
// column on ties), each column takes its highest bid (lowest row on ties),
// adds it to its price and changes owner. Writes row_to_col (B, N) int64
// (-1 for rows left at the bound), the final prices, and per element and
// phase the sweeps run and the rows that bid (stats (B, n_eps, 2) int32,
// zeroed by the caller).
//
// What bounds it on an H100: reading the benefit from device memory. The
// main path solves (9, 2048, 2048): 151 MB, three times the 50 MB L2, so a
// sweep in which every row bids reads all of it from HBM. Only rows without
// a column read their benefit row, so late sweeps read little.
//
// Design. One element's sweep is spread over a thread-block cluster of 8
// blocks of 1024 threads (9 x 8 = 72 blocks on the main path; clusters are
// scheduled as SMs free up, so any B runs), and the convergence test stays
// on the device: no host synchronisation between sweeps, each element
// leaves its phase by itself. The TPU kernel's column strips, double-
// buffered DMA and one-hot reductions are not carried over.
//   * Row pass: the cluster's 256 warps share the rows; a warp reads a
//     bidding row once (16-byte loads when M % 4 == 0, each lane in
//     ascending column order, then the shuffle merge of auction_common.cuh)
//     against a copy of the prices in its block's shared memory, and lane 0
//     posts one 64-bit atomicMax on the column's bid key.
//   * cluster.sync()
//   * Column pass: the cluster's 8192 threads share the columns, a column
//     always with the same thread; a column with a bid adds it to its price,
//     frees its old owner, seats the winner and clears its key. Old owners
//     and new winners are disjoint (owners do not bid), so the only atomic
//     is the count of owned columns.
//   * cluster.sync(), then every block reads that count and the new prices.
// Prices, owner map, bid keys, "assigned" flags and the owned count live in
// global memory (2048 x 20 bytes per element: it stays in L2); what another
// block wrote is read with __ldcg, past the SM's own L1.

#include <cooperative_groups.h>

#include "auction_common.cuh"

namespace cg = cooperative_groups;

namespace {

using auction::EpsList;
using auction::kMaxEps;

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Top-2 of row[j] - price[j] by one warp with 16-byte loads; the result is
// lane 0's.
__device__ __forceinline__ void top2_row_vec(const float* __restrict__ row,
                                             const float* price, int m,
                                             int lane, float& b1, int& j1,
                                             float& b2) {
  auction::top2_lane_vec(row, price, m, lane, b1, j1, b2);
  auction::top2_warp_merge(b1, j1, b2);
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
auction_hbm_kernel(const float* __restrict__ benefit,
                   const float* __restrict__ price_in, int n, int m,
                   EpsList eps, int max_sweeps,
                   long long* __restrict__ row_to_col, float* price,
                   unsigned long long* key, int* c2r, int* assigned,
                   int* owned, int* __restrict__ stats) {
  extern __shared__ __align__(16) float s_price[];  // (M,)
  __shared__ int s_owned;
  __shared__ int s_bidders;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cwarp = rank * kWarps + (tid >> 5);  // warp of the cluster
  const int cthread = rank * kThreads + tid;     // thread of the cluster
  benefit += (size_t)b * n * m;
  price_in += (size_t)b * m;
  price += (size_t)b * m;
  key += (size_t)b * m;
  c2r += (size_t)b * m;
  assigned += (size_t)b * n;
  owned += b;
  row_to_col += (size_t)b * n;
  stats += (size_t)b * eps.n * 2;

  for (int j = cthread; j < m; j += kCluster * kThreads) {
    price[j] = price_in[j];
  }

  for (int e = 0; e < eps.n; ++e) {
    const float eps_e = eps.v[e];
    for (int j = cthread; j < m; j += kCluster * kThreads) {
      c2r[j] = -1;
      key[j] = 0ull;
    }
    for (int r = cthread; r < n; r += kCluster * kThreads) assigned[r] = 0;
    if (cthread == 0) *owned = 0;
    if (tid == 0) s_bidders = 0;
    cluster.sync();

    int sweep = 0;
    for (; sweep < max_sweeps; ++sweep) {
      if (tid == 0) s_owned = __ldcg(owned);
      for (int j = tid; j < m; j += kThreads) s_price[j] = __ldcg(price + j);
      __syncthreads();
      // the same count in every block of the cluster: all leave together
      if (s_owned >= n) break;

      // bids: one warp per row without a column
      for (int r = cwarp; r < n; r += kCluster * kWarps) {
        if (__ldcg(assigned + r)) continue;
        float b1, b2;
        int j1;
        if (kVec) {
          top2_row_vec(benefit + (size_t)r * m, s_price, m, lane, b1, j1, b2);
        } else {
          auction::top2_row(benefit + (size_t)r * m, s_price, m, lane, b1, j1,
                            b2);
        }
        if (lane == 0) {
          atomicMax(&key[j1], auction::bid_key((b1 - b2) + eps_e, r));
          atomicAdd(&s_bidders, 1);
        }
      }
      cluster.sync();
      // columns: take the winning bid, seat the winner, free the old owner
      for (int j = cthread; j < m; j += kCluster * kThreads) {
        const unsigned long long k = __ldcg(key + j);
        if (k != 0ull) {
          const int winner = auction::key_row(k);
          price[j] = price[j] + auction::key_bid(k);
          const int old = c2r[j];
          if (old >= 0) {
            assigned[old] = 0;
          } else {
            atomicAdd(owned, 1);
          }
          c2r[j] = winner;
          assigned[winner] = 1;
          key[j] = 0ull;
        }
      }
      cluster.sync();
    }
    // every thread is past its read of s_owned before the next phase (or
    // the next sweep's thread 0) writes it again
    __syncthreads();
    if (tid == 0) {
      atomicAdd(stats + 2 * e + 1, s_bidders);
      if (rank == 0) stats[2 * e] = sweep;
    }
  }

  for (int r = cthread; r < n; r += kCluster * kThreads) row_to_col[r] = -1;
  cluster.sync();
  for (int j = cthread; j < m; j += kCluster * kThreads) {
    const int owner = c2r[j];
    if (owner >= 0) row_to_col[owner] = j;
  }
}

}  // namespace

// scratch, all written before read: key (B, M) uint64, c2r (B, M) int32,
// assigned (B, N) int32, owned (B,) int32. price_out doubles as the working
// prices. stats (B, n_eps, 2) int32 must come in zeroed.
extern "C" int reart_auction_resident_hbm(
    const float* benefit, const float* price_in, int batch, int n, int m,
    const float* eps, int n_eps, int max_sweeps, long long* row_to_col,
    float* price_out, unsigned long long* key, int* c2r, int* assigned,
    int* owned, int* stats, void* stream) {
  if (n_eps < 0 || n_eps > kMaxEps || batch < 1 || n < 1 || m < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpsList list{};
  for (int e = 0; e < n_eps; ++e) list.v[e] = eps[e];
  list.n = n_eps;
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  auto kernel = vec ? auction_hbm_kernel<true> : auction_hbm_kernel<false>;
  const size_t smem = 4 * (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * kCluster, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      benefit, price_in, n, m, list, max_sweeps, row_to_col, price_out, key,
      c2r, assigned, owned, stats);
  return static_cast<int>(cudaGetLastError());
}
