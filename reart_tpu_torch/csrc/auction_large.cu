// Epsilon-scaled Jacobi auction past 2048^2: the whole LAP solve in one
// launch, where the JAX package sweeps.
//
// Replaces the sweeps of reart_tpu/ops/pallas_auction.py past the streamed
// window: row_top2_pallas / _row_top2_kernel and col_winner_max_pallas /
// _col_winner_kernel, which ops/assignment._auction_phase drives once per
// sweep (two launches, a dozen small ops and a read-back to the host a
// sweep). Same contract as auction.cu (auction_cluster.cuh), plus stats
// (B, n_eps, 2) int32: per element and phase the sweeps run and the rows
// that bid, written by the kernel.
//
// What bounds it on an H100: the energy's presolve solves (9, 4096, 4096)
// with 4 phases of up to 400 sweeps, the sapien runs' dense solves (7,
// 4096, 4096) with 2 of up to 100. The benefit (604 MB at B = 9) streams
// from device memory: a phase's first sweep, where every row bids, reads
// all of it, and the few sweeps after it a fifth, a thirtieth... of it.
// Most sweeps are tails of a few straggler rows (on clouds that need them:
// 1 to 9 rows an element for hundreds of sweeps), paced by a row's read
// (16 KB by one warp: 32 / 8 round trips to memory), the cluster barrier
// and the column pass.
//
// Design: the cluster auction of auction_cluster.cuh (a cluster of 8 blocks
// of 1024 threads an element, 72 SMs at B = 9; each block holds the whole
// state, 135 KB at N = M = 4096; bids stored into per-row slots in every
// block; one cluster barrier a sweep), with its kSplit option: the split
// row pass for sweeps of at most 256 bidding rows (a row's columns shared
// by up to 32 warps of one block, which read it in about one round trip)
// and the stats; and, where the state fits with them (at N = 4096, M up
// to about 10800), the candidate cache and the tail on one block of
// auction_hbm.cu, which answer a straggler's bid from a few words of shared
// memory (faster on the card at the presolve and the engine's solves, in
// turns on one card), past that the split row pass alone. The JAX
// package's per-sweep passes over the whole matrix and its host loop are
// not carried over: only rows that bid read their benefit row, and the
// loop stays on the device.

#include "auction_cluster.cuh"

namespace {

using auction::EpsList;
using auction::kMaxEps;

constexpr int kCluster = 8;
// kCacheK columns cached a row, where the state fits with the cache
constexpr int kCacheK = REART_CACHE_K;

template <bool kVec, int kCache>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(auction::kClusterThreads)
    auction_large_kernel(const float* __restrict__ benefit,
                         const float* __restrict__ price_in, int n, int m,
                         EpsList eps, int max_sweeps, int nbuf,
                         long long* __restrict__ row_to_col,
                         float* __restrict__ price_out,
                         int* __restrict__ stats, int* __restrict__ probe) {
  const int b = blockIdx.x / kCluster;
  auction::cluster_solve<kCluster, auction::DenseRows<kVec>, true, kCache,
                         (kCache > 0)>(
      {benefit + (size_t)b * n * m, m}, price_in, n, m, eps, max_sweeps, nbuf,
      0, 0, row_to_col, price_out, stats, probe);
}

// The cache and the tail on one block where the state with the cache
// fits (two slot buffers, else one), else the split row pass alone: the
// slot buffers (0: the state does not fit), `cache` the columns cached a
// row, `smem` the shared-memory bytes.
int fit(int n, int m, int& cache, size_t& smem) {
  cache = kCacheK;
  int nbuf = auction::cluster_fit(n, m, true, cache, kCluster, 0, 0, smem);
  if (nbuf == 0) {
    cache = 0;
    nbuf = auction::cluster_fit(n, m, true, cache, kCluster, 0, 0, smem);
  }
  return nbuf;
}

}  // namespace

// What the launch below takes for an (n, m) element: out[0] the slot
// buffers (0: the state does not fit), out[1] the columns cached a row,
// out[2] the shared-memory bytes (0 where it does not fit). tile unused.
extern "C" int reart_auction_large_config(int n, int m, int, int* out) {
  size_t smem = 0;
  int cache = 0;
  const int nbuf = fit(n, m, cache, smem);
  out[0] = nbuf;
  out[1] = nbuf ? cache : 0;
  out[2] = nbuf ? static_cast<int>(smem) : 0;
  return 0;
}

// stats (B, n_eps, 2) int32 is written by the kernel; probe, when not
// null, (B, 2) int32 zeroed by the caller, gets per element the bids the
// cache answered and the rows read.
extern "C" int reart_auction_large(const float* benefit,
                                   const float* price_in, int batch, int n,
                                   int m, const float* eps, int n_eps,
                                   int max_sweeps, long long* row_to_col,
                                   float* price_out, int* stats, int* probe,
                                   void* stream) {
  if (n_eps < 1 || n_eps > kMaxEps || batch < 1 || n < 1 || m < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpsList list{};
  for (int e = 0; e < n_eps; ++e) list.v[e] = eps[e];
  list.n = n_eps;
  size_t smem = 0;
  int cache = 0;
  const int nbuf = fit(n, m, cache, smem);
  if (nbuf == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  auto kernel = cache ? (vec ? auction_large_kernel<true, kCacheK>
                             : auction_large_kernel<false, kCacheK>)
                      : (vec ? auction_large_kernel<true, 0>
                             : auction_large_kernel<false, 0>);
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
