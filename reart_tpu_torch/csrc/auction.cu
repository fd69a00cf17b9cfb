// Resident epsilon-scaled Jacobi auction: the whole LAP solve in one launch.
//
// Replaces reart_tpu/ops/pallas_auction.py: auction_solve_resident /
// _resident_kernel. For benefit (B, N, M) float32 with N <= M and prices
// (B, M), runs each epsilon phase of eps[0..n_eps) (high to low): every
// phase restarts from no owners and sweeps until all N rows own a column or
// max_sweeps is reached. In a sweep every unassigned row bids on its best
// column j1 of v = benefit - price, the bid being (v1 - v2) + eps with v2
// the best value over the other columns; each column with bids takes the
// highest (lowest row on ties), adds it to its price and changes owner.
// Writes row_to_col (B, N) int64 (-1 for rows unassigned at the bound) and
// the final prices. Rows left at -1 are completed greedily by the caller.
//
// What bounds it on an H100: reading the benefit. A full sweep reads the
// 4 MB benefit of an element (N = M = 1024); all 9 elements (36 MB) stay in
// the 50 MB L2 across sweeps, so the sweeps run at L2, not HBM, bandwidth.
// Assigned rows do not bid, so later sweeps read only the unassigned rows.
//
// Design: one persistent 1024-thread block per batch element (the TPU
// kernel's per-element grid step), so the convergence test runs on the
// device with no host sync, and each element exits its phase as soon as it
// converges. State is the column-owner map c2r as in the TPU kernel, kept in
// shared memory with the prices, a per-row "assigned" flag and a 64-bit bid
// key per column. A warp computes one row's top-2 (lanes stride the columns,
// then a shuffle merge with lowest-column ties; auction_common.cuh, shared
// with auction_hbm.cu) and its lane 0 posts
// atomicMax(key[j1], order(bid) << 32 | ~row): the highest bid wins and
// equal bids go to the lowest row, in any order of arrival. The column pass
// then applies prices and owners; old owners and new winners are disjoint
// sets (owners do not bid), so that pass needs no atomics beyond the owned
// count. Shared memory is 16 bytes per column plus a byte per row, so
// M <= ~14000; the main path uses M = 1024.

#include "auction_common.cuh"

namespace {

using auction::EpsList;
using auction::kMaxEps;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit,
               const float* __restrict__ price_in, int n, int m, EpsList eps,
               int max_sweeps, long long* __restrict__ row_to_col,
               float* __restrict__ price_out) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* key = smem_u64;                       // (M,)
  float* price = reinterpret_cast<float*>(key + m);         // (M,)
  int* c2r = reinterpret_cast<int*>(price + m);             // (M,)
  unsigned char* assigned = reinterpret_cast<unsigned char*>(c2r + m);  // (N,)
  __shared__ int s_owned;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  benefit += (size_t)b * n * m;

  for (int j = tid; j < m; j += kThreads) {
    price[j] = price_in[(size_t)b * m + j];
  }

  for (int e = 0; e < eps.n; ++e) {
    const float eps_e = eps.v[e];
    for (int j = tid; j < m; j += kThreads) {
      c2r[j] = -1;
      key[j] = 0ull;
    }
    for (int r = tid; r < n; r += kThreads) assigned[r] = 0;
    if (tid == 0) s_owned = 0;
    __syncthreads();

    for (int sweep = 0; s_owned < n && sweep < max_sweeps; ++sweep) {
      // bids: one warp per unassigned row
      for (int r = warp; r < n; r += kWarps) {
        if (assigned[r]) continue;
        float b1, b2;
        int j1;
        auction::top2_row(benefit + (size_t)r * m, price, m, lane, b1, j1,
                          b2);
        if (lane == 0) {
          atomicMax(&key[j1], auction::bid_key((b1 - b2) + eps_e, r));
        }
      }
      __syncthreads();
      // columns: take the winning bid, seat the winner, unseat the owner
      for (int j = tid; j < m; j += kThreads) {
        const unsigned long long k = key[j];
        if (k != 0ull) {
          const int winner = auction::key_row(k);
          price[j] = price[j] + auction::key_bid(k);
          const int old = c2r[j];
          if (old >= 0) {
            assigned[old] = 0;
          } else {
            atomicAdd(&s_owned, 1);
          }
          c2r[j] = winner;
          assigned[winner] = 1;
          key[j] = 0ull;
        }
      }
      __syncthreads();
    }
    // every thread has read s_owned for the exit test before the next
    // phase resets it
    __syncthreads();
  }

  for (int r = tid; r < n; r += kThreads) row_to_col[(size_t)b * n + r] = -1;
  __syncthreads();
  for (int j = tid; j < m; j += kThreads) {
    const int owner = c2r[j];
    if (owner >= 0) row_to_col[(size_t)b * n + owner] = j;
    price_out[(size_t)b * m + j] = price[j];
  }
}

}  // namespace

extern "C" int reart_auction_resident(const float* benefit,
                                      const float* price_in, int batch, int n,
                                      int m, const float* eps, int n_eps,
                                      int max_sweeps, long long* row_to_col,
                                      float* price_out, void* stream) {
  if (n_eps < 0 || n_eps > kMaxEps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpsList list{};
  for (int e = 0; e < n_eps; ++e) list.v[e] = eps[e];
  list.n = n_eps;
  const size_t smem = 16 * (size_t)m + (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<<<batch, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      benefit, price_in, n, m, list, max_sweeps, row_to_col, price_out);
  return static_cast<int>(cudaGetLastError());
}
