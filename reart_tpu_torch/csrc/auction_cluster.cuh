// The cluster auction shared by auction.cu (the resident window, N*M <=
// 1024^2) and auction_large.cu (past 2048^2): a whole epsilon-scaled Jacobi
// auction of one element on a thread-block cluster, in one launch.
//
// Contract. For benefit (B, N, M) float32 with N <= M and prices (B, M),
// runs each epsilon phase of eps[0..n_eps) (high to low): every phase
// restarts from no owners and sweeps until all N rows own a column or
// max_sweeps is reached. In a sweep every unassigned row bids on its best
// column j1 of v = benefit - price, the bid being (v1 - v2) + eps with v2
// the best value over the other columns; each column with bids takes the
// highest (lowest row on ties), adds it to its price and changes owner.
// Writes row_to_col (B, N) int64 (-1 for rows unassigned at the bound) and
// the final prices. Rows left at -1 are completed greedily by the caller.
//
// Design. One element is solved by a cluster of kCluster blocks of 1024
// threads, and the convergence test stays on the device: no host
// synchronisation between sweeps, each element leaves its phase by itself.
//   * Every block keeps the whole auction state in its shared memory:
//     prices, owner map c2r, "assigned" flags of the rows, the owned count,
//     the 64-bit bid keys of auction_common.cuh (highest bid, then lowest
//     row, in any order of arrival), and a slot per row for its bid.
//   * Row pass: the cluster's warps share the rows (a contiguous run each);
//     a warp reads a bidding row once (16-byte loads when M % 4 == 0) against
//     its block's prices, merges the lanes with three warp reductions, and
//     lanes 0..kCluster-1 store (bid, column) into the row's slot in every
//     block (distributed shared memory; one writer per slot, no atomics).
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
//
// kLarge (auction_large.cu) adds, for problems whose benefit streams from
// device memory and whose phases end in long tails of a few bidding rows:
//   * the split row pass: when at most kCluster * 32 rows bid, block `rank`
//     takes the bidding rows r with r % kCluster == rank and gives each of
//     them 32 / (its count of rows, rounded up to a power of two) warps,
//     each over a contiguous share of the columns; the warps' partial top-2
//     merge in shared memory under the same rule (larger value, then lower
//     column), which does not depend on how the columns were cut, so the
//     bids are the same. A straggler's row is then read in about one round
//     trip to memory instead of 32 / 8 of them by a single warp;
//   * stats (B, n_eps, 2) int32: per element and phase the sweeps run and
//     the rows that bid, as auction_hbm.cu reports them.
// Shared memory is 16 bytes per column plus 9 or 17 bytes per row (plus
// kSplitBytes for kLarge), so M <= ~14000.

#pragma once

#include <cooperative_groups.h>

#include "auction_common.cuh"

namespace auction {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 1024;
constexpr int kClusterWarps = kClusterThreads / 32;
// shared memory a block can use (227 KB) less the static part
constexpr size_t kClusterMaxSmem = 232448 - 64;

// The split row pass's scratch (kLarge): the block's bidding rows (at most
// kCluster * 32) and one partial top-2 (value, column, second value) per
// warp.
constexpr int kSplitRowsMax = 8 * kClusterWarps;
constexpr size_t kSplitBytes = 4 * kSplitRowsMax + 12 * kClusterWarps;

// Dynamic shared memory of an (n, m) element with nbuf slot buffers: keys,
// prices and owners 16 bytes a column, a slot buffer 8 bytes a row rounded
// to 16 bytes, a flag a row; kLarge's split scratch 16-byte aligned after.
inline size_t cluster_smem(int n, int m, int nbuf, bool large) {
  const size_t base =
      16 * (size_t)m + 8 * (size_t)((nbuf * n + 1) & ~1) + (size_t)n;
  return large ? ((base + 15) & ~size_t(15)) + kSplitBytes : base;
}

// A lane's part of the top-2 of row[j] - price[j] over the 16-byte groups
// q in [q0, q1) (columns 4q..4q+3): q = q0 + lane, q0 + lane + 32, ...,
// ascending, as top2_take wants; the split row pass's share of a row (the
// whole row is auction_common.cuh's top2_lane_vec). Needs m % 4 == 0 and
// aligned pointers.
__device__ __forceinline__ void top2_lane_vec_range(
    const float* __restrict__ row, const float* price, int q0, int q1,
    int lane, float& b1, int& j1, float& b2) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
  const float4* price4 = reinterpret_cast<const float4*>(price);
  b1 = -INFINITY;
  b2 = -INFINITY;
  j1 = INT_MAX;
#pragma unroll 8
  for (int q = q0 + lane; q < q1; q += 32) {
    const float4 x = __ldg(row4 + q);
    const float4 p = price4[q];
    top2_take(b1, j1, b2, x.x - p.x, 4 * q);
    top2_take(b1, j1, b2, x.y - p.y, 4 * q + 1);
    top2_take(b1, j1, b2, x.z - p.z, 4 * q + 2);
    top2_take(b1, j1, b2, x.w - p.w, 4 * q + 3);
  }
}

// The same over the columns j in [j0, j1e), one at a time.
__device__ __forceinline__ void top2_lane_range(const float* __restrict__ row,
                                                const float* price, int j0,
                                                int j1e, int lane, float& b1,
                                                int& j1, float& b2) {
  b1 = -INFINITY;
  b2 = -INFINITY;
  j1 = INT_MAX;
#pragma unroll 8
  for (int j = j0 + lane; j < j1e; j += 32) {
    top2_take(b1, j1, b2, __ldg(row + j) - price[j], j);
  }
}

// The row pass of a sweep: each warp of the cluster its contiguous run of
// rows [row0, row_end), one bidding row at a time by the whole warp.
template <int kCluster, bool kVec>
__device__ __forceinline__ void warp_row_pass(
    const float* __restrict__ benefit, const float* price,
    const unsigned char* assigned, uint2* slot, int m, int row0, int row_end,
    float eps_e) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  // 32 flags at a time; lanes 0..kCluster-1 store the row's (bid, column)
  // into its slot in every block (a row whose values are all -inf has no
  // column: INT_MAX)
  for (int base = row0; base < row_end; base += 32) {
    const int mine = base + lane;
    unsigned bidders = __ballot_sync(0xffffffffu,
                                     mine < row_end && !assigned[mine]);
    while (bidders) {
      const int r = base + __ffs(bidders) - 1;
      bidders &= bidders - 1;
      float b1, b2;
      int j1;
      if constexpr (kVec) {
        top2_lane_vec(benefit + (size_t)r * m, price, m, lane, b1, j1, b2);
      } else {
        top2_lane(benefit + (size_t)r * m, price, m, lane, b1, j1, b2);
      }
      top2_warp_redux(b1, j1, b2);
      if (lane < kCluster) {
        *cluster.map_shared_rank(slot + r, lane) =
            make_uint2(__float_as_uint((b1 - b2) + eps_e),
                       static_cast<unsigned>(j1));
      }
    }
  }
}

// The split row pass (kLarge) for a sweep of at most kCluster * 32 bidding
// rows: this block's bidding rows r % kCluster == rank, each read by as
// many warps as the count allows, over contiguous shares of its columns.
template <int kCluster, bool kVec>
__device__ __forceinline__ void split_row_pass(
    const float* __restrict__ benefit, const float* price,
    const unsigned char* assigned, uint2* slot, int n, int m, float eps_e,
    int* split_rows, float* part_b1, float* part_b2, int* part_j1) {
  constexpr int kThreads = kClusterThreads;
  constexpr int kWarps = kClusterWarps;
  __shared__ int s_split_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_split_count = 0;
  __syncthreads();
  for (int r = rank + kCluster * tid; r < n; r += kCluster * kThreads) {
    if (!assigned[r]) split_rows[atomicAdd(&s_split_count, 1)] = r;
  }
  __syncthreads();
  const int count = s_split_count;
  // warps a row: the largest power of two w with w * count <= 32
  int per_row = kWarps;
  while (per_row > 1 && per_row * count > kWarps) per_row >>= 1;
  const int rows_per_round = kWarps / per_row;
  const int share = warp % per_row;
  for (int base = 0; base < count; base += rows_per_round) {
    const int k = base + warp / per_row;
    if (k < count) {
      const float* row = benefit + (size_t)split_rows[k] * m;
      float b1, b2;
      int j1;
      if constexpr (kVec) {
        const int groups = m >> 2;
        const int len = (groups + per_row - 1) / per_row;
        top2_lane_vec_range(row, price, share * len,
                            min(groups, (share + 1) * len), lane, b1, j1, b2);
      } else {
        const int len = (m + per_row - 1) / per_row;
        top2_lane_range(row, price, share * len,
                        min(m, (share + 1) * len), lane, b1, j1, b2);
      }
      top2_warp_redux(b1, j1, b2);
      if (lane == 0) {
        part_b1[warp] = b1;
        part_b2[warp] = b2;
        part_j1[warp] = j1;
      }
    }
    __syncthreads();
    // warp g merges the per_row partials of round row g
    const int k2 = base + warp;
    if (warp < rows_per_round && k2 < count) {
      float b1 = -INFINITY, b2 = -INFINITY;
      int j1 = INT_MAX;
      if (lane < per_row) {
        const int w = warp * per_row + lane;
        b1 = part_b1[w];
        b2 = part_b2[w];
        j1 = part_j1[w];
      }
      top2_warp_redux(b1, j1, b2);
      if (lane < kCluster) {
        *cluster.map_shared_rank(slot + split_rows[k2], lane) =
            make_uint2(__float_as_uint((b1 - b2) + eps_e),
                       static_cast<unsigned>(j1));
      }
    }
    __syncthreads();
  }
}

template <int kCluster, bool kVec, bool kLarge>
__device__ __forceinline__ void cluster_solve(
    const float* __restrict__ benefit, const float* __restrict__ price_in,
    int n, int m, EpsList eps, int max_sweeps, int nbuf,
    long long* __restrict__ row_to_col, float* __restrict__ price_out,
    int* __restrict__ stats) {
  constexpr int kThreads = kClusterThreads;
  constexpr int kWarps = kClusterWarps;
  static_assert(kCluster * kWarps <= kSplitRowsMax, "split scratch");
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  unsigned long long* key = smem_u64;                        // (M,)
  uint2* slots = reinterpret_cast<uint2*>(key + m);          // (nbuf, N)
  // 16-byte aligned for the 16-byte loads (M % 4 == 0 there)
  float* price = reinterpret_cast<float*>(slots + ((nbuf * n + 1) & ~1));
  int* c2r = reinterpret_cast<int*>(price + m);              // (M,)
  unsigned char* assigned = reinterpret_cast<unsigned char*>(c2r + m);  // (N,)
  // kLarge: this block's bidding rows, then the warps' partial top-2
  int* split_rows = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(assigned + n) + 15) & ~uintptr_t(15));
  float* part_b1 = reinterpret_cast<float*>(split_rows + kSplitRowsMax);
  float* part_b2 = part_b1 + kWarps;
  int* part_j1 = reinterpret_cast<int*>(part_b2 + kWarps);
  __shared__ int s_owned;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
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

    int sweep = 0;
    int bid_rows = 0;  // kLarge's stats: rows that bid in this phase
    for (; s_owned < n && sweep < max_sweeps; ++sweep) {
      uint2* slot = slots + (sweep % nbuf) * n;
      if constexpr (kLarge) {
        const int bidders = n - s_owned;  // the same in every block
        bid_rows += bidders;
        if (bidders <= kCluster * kWarps) {
          split_row_pass<kCluster, kVec>(benefit, price, assigned, slot, n, m,
                                         eps_e, split_rows, part_b1, part_b2,
                                         part_j1);
        } else {
          warp_row_pass<kCluster, kVec>(benefit, price, assigned, slot, m,
                                        row0, row_end, eps_e);
        }
      } else {
        warp_row_pass<kCluster, kVec>(benefit, price, assigned, slot, m, row0,
                                      row_end, eps_e);
      }
      cluster.sync();
      // every block folds the bids of the rows without a column (every
      // such row bid this sweep) into its column keys
      for (int r = tid; r < n; r += kThreads) {
        if (!assigned[r]) {
          const uint2 s = slot[r];
          if (s.y < static_cast<unsigned>(m)) {
            atomicMax(&key[s.y], bid_key(__uint_as_float(s.x), r));
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
          const int winner = key_row(k);
          price[j] = price[j] + key_bid(k);
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
    if constexpr (kLarge) {
      if (rank == 0 && tid == 0) {
        stats[((size_t)b * eps.n + e) * 2] = sweep;
        stats[((size_t)b * eps.n + e) * 2 + 1] = bid_rows;
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

// Host side: the slot buffers (two where they fit) and the dynamic shared
// memory of an (n, m) element; 0 buffers when one does not fit.
inline int cluster_buffers(int n, int m, bool large) {
  if (cluster_smem(n, m, 2, large) <= kClusterMaxSmem) return 2;
  if (cluster_smem(n, m, 1, large) <= kClusterMaxSmem) return 1;
  return 0;
}

}  // namespace auction
