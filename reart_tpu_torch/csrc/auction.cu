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
// Design. One element is solved by a thread-block cluster of 8 blocks (72
// SMs at B = 9; clusters are scheduled as SMs free up, so any B runs), and
// the convergence test stays on the device: no host synchronisation between
// sweeps, each element leaves its phase by itself.
//   * Every block keeps the whole auction state in its shared memory:
//     prices, owner map c2r, "assigned" flags of the rows, the owned count,
//     the 64-bit bid keys of auction_common.cuh (highest bid, then lowest
//     row, in any order of arrival), and a slot per row for its bid.
//   * Row pass: the cluster's warps share the rows (a contiguous run each);
//     a warp reads a bidding row once (16-byte loads when M % 4 == 0) against
//     its block's prices, merges the lanes with three warp reductions, and
//     lanes 0-7 store (bid, column) into the row's slot in all 8 blocks
//     (distributed shared memory; one writer per slot, no atomics).
//   * One cluster barrier; then every block folds the slots of the rows that
//     bid into its column keys with local atomicMax, and applies every bid
//     to its own copy: the same bids in each block give the same prices,
//     owners and count. A __syncthreads ends the sweep. The slots are
//     double-buffered by sweep: the next sweep stores into the other
//     buffer, which every block read a sweep earlier, so no second cluster
//     barrier is needed. Where two buffers do not fit, a cluster barrier
//     ends the sweep instead, over one buffer. A cluster barrier ends each
//     phase.
//   * A 64-bit atomicMax posted straight into another block's shared memory
//     lost bids under contention on the card (results off the plain
//     version's in a few rows), hence the slots. Handing the late sweeps
//     (a few bidders) to one block without cluster barriers was slower on
//     the card, and so was a block of 256 or 512 threads.
// Shared memory is 16 bytes per column plus 9 or 17 bytes per row, so
// M <= ~14000 (resident_available); the main path uses M = 1024.

#include <cooperative_groups.h>

#include "auction_common.cuh"

namespace cg = cooperative_groups;

namespace {

using auction::EpsList;
using auction::kMaxEps;

constexpr int kCluster = 8;
// measured on an H100 against 256 and 512: the first sweeps, where every
// row bids, take most of a solve, and 1024 threads read 4 rows a warp
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// shared memory a block can use (227 KB) less the static part
constexpr size_t kMaxSmem = 232448 - 64;

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit,
               const float* __restrict__ price_in, int n, int m, EpsList eps,
               int max_sweeps, int nbuf, long long* __restrict__ row_to_col,
               float* __restrict__ price_out) {
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  unsigned long long* key = smem_u64;                        // (M,)
  uint2* slots = reinterpret_cast<uint2*>(key + m);          // (nbuf, N)
  // 16-byte aligned for the 16-byte loads (M % 4 == 0 there)
  float* price = reinterpret_cast<float*>(slots + ((nbuf * n + 1) & ~1));
  int* c2r = reinterpret_cast<int*>(price + m);              // (M,)
  unsigned char* assigned = reinterpret_cast<unsigned char*>(c2r + m);  // (N,)
  __shared__ int s_owned;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the rows of this warp of the cluster: [row0, row_end)
  const int per_warp = (n + kCluster * kWarps - 1) / (kCluster * kWarps);
  const int row0 = (rank * kWarps + (tid >> 5)) * per_warp;
  const int row_end = min(n, row0 + per_warp);
  benefit += (size_t)b * n * m;

  for (int j = tid; j < m; j += kThreads) {
    price[j] = price_in[(size_t)b * m + j];
    key[j] = 0ull;
  }
  // every block has started before a bid is stored into it
  cluster.sync();

  for (int e = 0; e < eps.n; ++e) {
    const float eps_e = eps.v[e];
    for (int j = tid; j < m; j += kThreads) c2r[j] = -1;
    for (int r = tid; r < n; r += kThreads) assigned[r] = 0;
    if (tid == 0) s_owned = 0;
    __syncthreads();

    for (int sweep = 0; s_owned < n && sweep < max_sweeps; ++sweep) {
      uint2* slot = slots + (sweep % nbuf) * n;
      // bids: each warp its rows without a column, 32 flags at a time;
      // lanes 0-7 store the row's (bid, column) into its slot in all 8
      // blocks (a row whose values are all -inf has no column: INT_MAX)
      for (int base = row0; base < row_end; base += 32) {
        const int mine = base + lane;
        unsigned bidders = __ballot_sync(
            0xffffffffu, mine < row_end && !assigned[mine]);
        while (bidders) {
          const int r = base + __ffs(bidders) - 1;
          bidders &= bidders - 1;
          float b1, b2;
          int j1;
          if constexpr (kVec) {
            auction::top2_lane_vec(benefit + (size_t)r * m, price, m, lane,
                                   b1, j1, b2);
          } else {
            auction::top2_lane(benefit + (size_t)r * m, price, m, lane, b1,
                               j1, b2);
          }
          auction::top2_warp_redux(b1, j1, b2);
          if (lane < kCluster) {
            *cluster.map_shared_rank(slot + r, lane) = make_uint2(
                __float_as_uint((b1 - b2) + eps_e), static_cast<unsigned>(j1));
          }
        }
      }
      cluster.sync();
      // every block folds the bids of the rows without a column (every
      // such row bid this sweep) into its column keys
      for (int r = tid; r < n; r += kThreads) {
        if (!assigned[r]) {
          const uint2 s = slot[r];
          if (s.y < static_cast<unsigned>(m)) {
            atomicMax(&key[s.y], auction::bid_key(__uint_as_float(s.x), r));
          }
        }
      }
      __syncthreads();
      // columns: take the winning bid, seat the winner, free the old owner;
      // old owners and new winners are disjoint (owners do not bid)
      for (int j = tid; j < m; j += kThreads) {
        const unsigned long long k = key[j];
        if (k != 0ull) {
          key[j] = 0ull;
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
        }
      }
      if (nbuf == 2) {
        __syncthreads();
      } else {
        cluster.sync();
      }
    }
    // every block ends the phase here: the next phase's sweeps start their
    // slot buffers afresh, and every thread has read s_owned for the exit
    // test before the next phase resets it
    cluster.sync();
  }

  // every block holds the same result; block 0 writes it
  if (rank == 0) {
    for (int r = tid; r < n; r += kThreads) row_to_col[(size_t)b * n + r] = -1;
    __syncthreads();
    for (int j = tid; j < m; j += kThreads) {
      const int owner = c2r[j];
      if (owner >= 0) row_to_col[(size_t)b * n + owner] = j;
      price_out[(size_t)b * m + j] = price[j];
    }
  }
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
  // keys, prices and owners 16 bytes a column; a flag and a slot buffer 9
  // bytes a row (the buffer rounded to 16 bytes)
  const auto smem_for = [&](int bufs) {
    return 16 * (size_t)m + 8 * (size_t)((bufs * n + 1) & ~1) + (size_t)n;
  };
  const int nbuf = smem_for(2) <= kMaxSmem ? 2 : 1;
  const size_t smem = smem_for(nbuf);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  auto kernel = vec ? auction_kernel<true> : auction_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * kCluster, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      benefit, price_in, n, m, list, max_sweeps, nbuf, row_to_col, price_out);
  return static_cast<int>(cudaGetLastError());
}
