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
// phase the sweeps run and the rows that bid (stats (B, n_eps, 2) int32).
//
// What bounds it on an H100: a phase's first sweeps read the benefit from
// device memory (the main path solves (9, 2048, 2048): 151 MB, three times
// the 50 MB L2); after them a phase is a long tail of sweeps in which a few
// rows bid (the slowest element of the projection fit's warm solve: 10 +
// 66 sweeps), each sweep paced by its fixed costs (barriers, the column
// pass, a straggler's row read), not by bytes or arithmetic.
//
// Design: the cluster auction of auction_cluster.cuh (a cluster of 8 blocks
// of 1024 threads an element, the whole state in every block's shared
// memory, bids stored into per-row slots in every block, one cluster
// barrier a sweep) with the split row pass and stats of auction_large.cu,
// and two options for the tail: the candidate cache (a row's best kCacheK
// columns and a bound on the rest, so that a straggler's bid reads a few
// words of shared memory instead of its 8 KB row) and, once few rows bid,
// the rest of the phase on one block of the cluster without cluster
// barriers. The state needs 16 bytes a column plus about 30 a row, so the
// wrapper admits the shapes of the window whose state fits (M up to about
// 14000); the TPU kernel's column strips and one-hot reductions are not
// carried over.

#include "auction_cluster.cuh"

namespace {

using auction::EpsList;
using auction::kMaxEps;

constexpr int kCluster = 8;

// kCacheK columns cached a row
constexpr int kCacheK = REART_CACHE_K;

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(auction::kClusterThreads)
    auction_hbm_kernel(const float* __restrict__ benefit,
                       const float* __restrict__ price_in, int n, int m,
                       EpsList eps, int max_sweeps, int nbuf,
                       long long* __restrict__ row_to_col,
                       float* __restrict__ price_out, int* __restrict__ stats,
                       int* __restrict__ probe) {
  const int b = blockIdx.x / kCluster;
  auction::cluster_solve<kCluster, auction::DenseRows<kVec>, true, kCacheK,
                         true>({benefit + (size_t)b * n * m, m}, price_in, n,
                               m, eps, max_sweeps, nbuf, 0, 0, row_to_col,
                               price_out, stats, probe);
}

// The slot buffers of an (n, m) element's state (0: it does not fit) and
// its shared-memory bytes.
int fit(int n, int m, size_t& smem) {
  return auction::cluster_fit(n, m, true, kCacheK, kCluster, 0, 0, smem);
}

}  // namespace

// What the launch below takes for an (n, m) element: out[0] the slot
// buffers (0: the state does not fit), out[1] the columns cached a row,
// out[2] the shared-memory bytes (0 where it does not fit). tile unused.
extern "C" int reart_auction_resident_hbm_config(int n, int m, int,
                                                 int* out) {
  size_t smem = 0;
  const int nbuf = fit(n, m, smem);
  out[0] = nbuf;
  out[1] = nbuf ? kCacheK : 0;
  out[2] = nbuf ? static_cast<int>(smem) : 0;
  return 0;
}

// stats (B, n_eps, 2) int32 is written by the kernel; probe, when not
// null, (B, 2) int32 zeroed by the caller, gets per element the bids the
// cache answered and the rows read.
extern "C" int reart_auction_resident_hbm(
    const float* benefit, const float* price_in, int batch, int n, int m,
    const float* eps, int n_eps, int max_sweeps, long long* row_to_col,
    float* price_out, int* stats, int* probe, void* stream) {
  if (n_eps < 1 || n_eps > kMaxEps || batch < 1 || n < 1 || m < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpsList list{};
  for (int e = 0; e < n_eps; ++e) list.v[e] = eps[e];
  list.n = n_eps;
  size_t smem = 0;
  const int nbuf = fit(n, m, smem);
  if (nbuf == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  auto kernel = vec ? auction_hbm_kernel<true> : auction_hbm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * kCluster, auction::kClusterThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      benefit, price_in, n, m, list, max_sweeps, nbuf, row_to_col, price_out,
      stats, probe);
  return static_cast<int>(cudaGetLastError());
}
