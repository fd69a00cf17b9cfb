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
// What bounds it on an H100: the chain of sweeps. The main path solves
// (9, 1024, 1024); its 36 MB of benefit stay in the 50 MB L2, and a sweep
// reads only the rows that bid: all of them in a phase's first sweep, a
// handful late in a phase. One SM's reads (the TPU kernel's one instance
// per element) cannot pull a first sweep's 4 MB quickly; a late sweep costs
// about one L2 round trip for a row, a warp merge and the sweep's barriers.
//
// Design: the cluster auction of auction_cluster.cuh (a cluster of 8 blocks
// of 1024 threads an element, the whole state in every block's shared
// memory, bids stored into per-row slots in every block, one cluster
// barrier a sweep), launched here for the resident window; auction_large.cu
// launches the same sweep past 2048^2.

#include "auction_cluster.cuh"

namespace {

using auction::EpsList;
using auction::kMaxEps;

constexpr int kCluster = 8;

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(auction::kClusterThreads)
    auction_kernel(const float* __restrict__ benefit,
                   const float* __restrict__ price_in, int n, int m,
                   EpsList eps, int max_sweeps, int nbuf,
                   long long* __restrict__ row_to_col,
                   float* __restrict__ price_out) {
  const int b = blockIdx.x / kCluster;
  auction::cluster_solve<kCluster, auction::DenseRows<kVec>, false, 0, false>(
      {benefit + (size_t)b * n * m, m}, price_in, n, m, eps, max_sweeps, nbuf,
      0, 0, row_to_col, price_out, nullptr, nullptr);
}

}  // namespace

extern "C" int reart_auction_resident(const float* benefit,
                                      const float* price_in, int batch, int n,
                                      int m, const float* eps, int n_eps,
                                      int max_sweeps, long long* row_to_col,
                                      float* price_out, void* stream) {
  if (n_eps < 0 || n_eps > kMaxEps || batch < 1 || n < 1 || m < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpsList list{};
  for (int e = 0; e < n_eps; ++e) list.v[e] = eps[e];
  list.n = n_eps;
  size_t smem = 0;
  const int nbuf = auction::cluster_fit(n, m, false, 0, kCluster, 0, 0, smem);
  if (nbuf == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  auto kernel = vec ? auction_kernel<true> : auction_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * kCluster, auction::kClusterThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      benefit, price_in, n, m, list, max_sweeps, nbuf, row_to_col, price_out);
  return static_cast<int>(cudaGetLastError());
}
