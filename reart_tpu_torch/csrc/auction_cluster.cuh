// The cluster auction shared by auction.cu (the resident window, N*M <=
// 1024^2), auction_hbm.cu (the streamed window, up to 2048^2),
// auction_large.cu (past 2048^2) and auction_banded.cu (the banded solve
// from curve-sorted points): a whole epsilon-scaled Jacobi auction of one
// element on a thread-block cluster, in one launch.
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
// A row's columns ("its domain") come from a Rows policy: DenseRows reads
// the M entries of its benefit row; auction_banded.cu's rows recompute the
// w entries of their window from the points.
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
//     version's in a few rows), hence the slots.
//
// Options, each a template flag, for problems whose phases end in long
// tails of a few bidding rows (auction.cu takes none of them):
//   * kSplit, the split row pass: when at most kCluster * 32 rows bid,
//     block `rank` takes the bidding rows r with r % kCluster == rank and
//     gives each of them 32 / (its count of rows, rounded up to a power of
//     two) warps, each over a contiguous share of the row's domain; the
//     warps' partial results merge in shared memory under the same rule
//     (larger value, then lower column), which does not depend on how the
//     columns were cut, so the bids are the same. Stats (B, n_eps, 2 or 3)
//     int32: per element and phase the sweeps run, the rows that bid (and
//     for the banded rows the row tiles that bid);
//   * kCacheK > 0, a candidate cache per row, exact because prices only
//     rise: a bid is positive, so within a launch no price falls, and as
//     IEEE subtraction is monotone no value v = benefit - price rises.
//     Whenever a row's domain is read, each lane keeps its best column and
//     its second value (one more register than the top-2 itself), and the
//     warp merges the lanes' lists (Cands::pop): up to kCacheK of the best
//     columns are kept with their benefit (in the shared memory of block
//     r % kCluster), and beta, the next value in the merge, bounds every
//     other column from then on. A later bid recomputes the cached values
//     against the current prices (the same subtraction); where v1 > beta
//     and v2 >= beta the cached top-2 is the row's top-2 (v1, its lowest
//     column, v2), else the row is read again and its cache refreshed. A
//     straggler's bid then costs a few shared-memory reads;
//   * kTail (dense rows), the tail on one block: when at most kTailRows
//     rows bid, block 0 runs the rest of the phase alone, with
//     __syncthreads and no cluster barrier or remote slots (its warps post
//     bids straight into their own keys), reading the other blocks' caches
//     remotely; at the phase's end it copies its prices into the other
//     blocks (the next phase starts from no owners). Handing the late
//     sweeps to one block was slower for the resident window without the
//     cache (its first sweeps dominate); the streamed window's warm solve
//     gains about 10% from it.

#pragma once

#include <cooperative_groups.h>

#include "auction_common.cuh"

namespace auction {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 1024;
constexpr int kClusterWarps = kClusterThreads / 32;
// shared memory a block can use (227 KB) less the static part
constexpr size_t kClusterMaxSmem = 232448 - 64;

// The split row pass's scratch: the block's bidding rows (at most
// kCluster * 32) and one partial top-2 (value, column, second value) per
// warp.
constexpr int kSplitRowsMax = 8 * kClusterWarps;
// The options' sizes come from ops/_build.py, one -D flag each, where the
// wrappers' size gates read them too: REART_CACHE_K, the columns the
// streamed and large kernels cache a row; REART_BAND_CACHE_K, the banded
// kernel's (0: none); REART_TAIL_ROWS, kTailRows.
#if !defined(REART_CACHE_K) || !defined(REART_BAND_CACHE_K) || \
    !defined(REART_TAIL_ROWS)
#error "REART_CACHE_K, REART_BAND_CACHE_K and REART_TAIL_ROWS: see ops/_build.py"
#endif
// kTail: the bidding rows at or below which block 0 runs the rest of a
// phase alone (about the same from 8 to 64 on the card)
constexpr int kTailRows = REART_TAIL_ROWS;
constexpr size_t kSplitBytes = 4 * kSplitRowsMax + 12 * kClusterWarps;

// The cache's scratch and state: a partial list of K + 1 (value, benefit,
// column) per warp, then per row of the block (ceil(N / kCluster)) K
// (benefit, column) pairs and beta.
__host__ __device__ inline size_t cache_bytes(int n, int k, int cluster) {
  const size_t rows = (size_t)((n + cluster - 1) / cluster);
  return 12 * (size_t)kClusterWarps * (k + 1) + rows * (8 * (size_t)k + 4);
}

// Byte offsets into the dynamic shared memory of an (n, m) element with
// nbuf slot buffers: keys 8 bytes a column, the slot buffers 8 bytes a row
// rounded to 16 bytes, prices and owners 4 bytes a column (prices 16-byte
// aligned for the 16-byte loads), a flag a row; then, 16-byte aligned, the
// split row pass's scratch, the cache, the target points (the banded
// rows' 12 bytes a point) and a flag a row tile.
struct ClusterLayout {
  size_t slots, price, c2r, assigned, split, cache, tgt, tiles, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(
    int n, int m, int nbuf, bool split, int cache_k, int cluster,
    int tgt_points, int ntiles) {
  ClusterLayout l;
  l.slots = 8 * (size_t)m;
  l.price = l.slots + 8 * (size_t)((nbuf * n + 1) & ~1);
  l.c2r = l.price + 4 * (size_t)m;
  l.assigned = l.c2r + 4 * (size_t)m;
  size_t end = l.assigned + n;
  l.split = (end + 15) & ~size_t(15);
  if (split) end = l.split + kSplitBytes;
  l.cache = (end + 15) & ~size_t(15);
  if (cache_k > 0) end = l.cache + cache_bytes(n, cache_k, cluster);
  l.tgt = (end + 15) & ~size_t(15);
  if (tgt_points > 0) end = l.tgt + 12 * (size_t)tgt_points;
  l.tiles = end;
  l.bytes = end + ntiles;
  return l;
}

// Host side: the slot buffers of an element's state, two where they fit,
// else one, else 0; `smem` gets the bytes.
inline int cluster_fit(int n, int m, bool split, int cache_k, int cluster,
                       int tgt_points, int ntiles, size_t& smem) {
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    smem = cluster_layout(n, m, nbuf, split, cache_k, cluster, tgt_points,
                          ntiles)
               .bytes;
    if (smem <= kClusterMaxSmem) return nbuf;
  }
  return 0;
}

// Dense rows: row r's domain is its M entries of benefit (this element's
// (N, M)), walked in units of 16 bytes when kVec (M % 4 == 0, aligned).
template <bool kVec>
struct DenseRows {
  static constexpr bool kBand = false;
  const float* __restrict__ benefit;
  int m;

  __device__ __forceinline__ int smem_points() const { return 0; }

  __device__ __forceinline__ int units(int) const {
    return kVec ? m >> 2 : m;
  }

  // Calls f(benefit, value, column) for the units q0 + lane, q0 + lane +
  // 32, ... below q1: a lane's columns in ascending order.
  template <class F>
  __device__ __forceinline__ void walk(int r, const float* price, int q0,
                                       int q1, int lane, F&& f) const {
    const float* row = benefit + (size_t)r * m;
    if constexpr (kVec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const float4* price4 = reinterpret_cast<const float4*>(price);
#pragma unroll 8
      for (int q = q0 + lane; q < q1; q += 32) {
        const float4 x = __ldg(row4 + q);
        const float4 p = price4[q];
        f(x.x, x.x - p.x, 4 * q);
        f(x.y, x.y - p.y, 4 * q + 1);
        f(x.z, x.z - p.z, 4 * q + 2);
        f(x.w, x.w - p.w, 4 * q + 3);
      }
    } else {
#pragma unroll 8
      for (int j = q0 + lane; j < q1; j += 32) {
        const float x = __ldg(row + j);
        f(x, x - price[j], j);
      }
    }
  }
};

// Candidate lists. An entry is (value, benefit, column); column kBound
// marks a bound: a value that some column reaches, every column listed
// after it or left out of the list being at most that. A lane's walk keeps
// L = 2: its best (the lowest of its columns of the best value, as
// top2_take keeps it) and, as a bound, its second value; a warp's merged
// candidates are L = K + 1: up to K columns, then a bound.
constexpr unsigned kBound = 0xffffffffu;

template <int L>
struct Cands {
  float v[L], x[L];
  unsigned j[L];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      v[i] = -INFINITY;
      x[i] = -INFINITY;
      j[i] = i == 0 ? INT_MAX : kBound;
    }
  }

  // one more column of a lane's walk in ascending column order (L = 2)
  __device__ __forceinline__ void take(float bx, float val, int col) {
    if (val > v[0]) {
      v[1] = v[0];
      v[0] = val;
      x[0] = bx;
      j[0] = static_cast<unsigned>(col);
    } else {
      v[1] = fmaxf(v[1], val);
    }
  }

  // Merges the 32 lanes' lists: up to K + 1 times the largest head (larger
  // value, then lower column; -0 and +0 one value, as in top2_warp_redux)
  // leaves its lane. The heads taken while they are columns are the
  // candidates: put(k, value, benefit, column) is called by the lane that
  // held the k-th. The first head that is a bound, or the (K + 1)-th,
  // gives beta, a bound on every other column. Every lane ends with the
  // top2_warp_redux result (b1, j1, b2) and beta; returns the count of
  // candidates.
  template <int K, class Put>
  __device__ __forceinline__ int pop(int m, float& b1, int& j1, float& b2,
                                     float& beta, Put&& put) {
    int taken = 0;
    bool open = true;
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      const uint32_t key = ordered_bits(v[0] + 0.0f);
      const uint32_t top = __reduce_max_sync(0xffffffffu, key);
      const uint32_t col =
          __reduce_min_sync(0xffffffffu, key == top ? j[0] : 0xffffffffu);
      const float val = from_ordered(top);
      const bool mine = key == top && j[0] == col;
      if (k == 0) {
        b1 = val;
        j1 = col < static_cast<unsigned>(m) ? static_cast<int>(col) : INT_MAX;
      }
      if (k == 1) b2 = val;
      if (open) {
        if (k < K && col < static_cast<unsigned>(m)) {
          if (mine) put(k, val, x[0], static_cast<int>(col));
          ++taken;
        } else {
          beta = val;
          open = false;
        }
      }
      if (mine) {
#pragma unroll
        for (int i = 0; i + 1 < L; ++i) {
          v[i] = v[i + 1];
          x[i] = x[i + 1];
          j[i] = j[i + 1];
        }
        v[L - 1] = -INFINITY;
        j[L - 1] = kBound;
      }
      if (!open && k >= 1) break;
    }
    return taken;
  }
};

// The cached top-2 of a row, one entry a lane: true when the cache answers
// (b1 > beta and b2 >= beta); b1, j1, b2 are then the row's top-2 under
// `price`, as a full read would give them.
template <int K>
__device__ __forceinline__ bool cache_top2(const uint2* entries, float beta,
                                           const float* price, int m,
                                           int lane, float& b1, int& j1,
                                           float& b2) {
  b1 = -INFINITY;
  b2 = -INFINITY;
  j1 = INT_MAX;
  if (lane < K) {
    const uint2 e = entries[lane];
    if (e.y < static_cast<unsigned>(m)) {
      j1 = static_cast<int>(e.y);
      b1 = __uint_as_float(e.x) - price[j1];
    }
  }
  top2_warp_redux(b1, j1, b2);
  return b1 > beta && b2 >= beta;
}

template <int kCluster, class Rows, bool kSplit, int kCacheK, bool kTail>
struct ClusterSolver {
  static constexpr int kThreads = kClusterThreads;
  static constexpr int kWarps = kClusterWarps;
  static constexpr int K = kCacheK;
  static constexpr int kStatCols = Rows::kBand ? 3 : 2;
  static_assert(kCluster * kWarps <= kSplitRowsMax, "split scratch");
  static_assert(!kTail || kSplit, "the tail runs the split row pass");
  static_assert(K == 0 || kSplit, "the cache runs with the split row pass");
  static constexpr bool kFused = K > 0 || kTail;
  static_assert(!(Rows::kBand && kTail), "the banded rows keep owners across "
                "phases: their tail stays on the cluster");

  Rows rows;
  int n, m, rank, tid, lane, warp;
  unsigned long long* key;
  uint2* slots;
  float* price;
  int* c2r;
  unsigned char* assigned;
  // split row pass: the block's bidding rows, the warps' partial top-2
  int* split_rows;
  float *part_b1, *part_b2;
  int* part_j1;
  // cache: the warps' partial lists, the entries
  float *list_v, *list_b;
  int* list_j;
  uint2* cache_e;
  float* cache_beta;
  // banded rows: a flag a row tile, and the tile size
  unsigned char* tile_flag;
  int tile, ntiles;
  int* s_owned;
  int* s_count;  // [2]: the rows to read, by sweep parity
  int* s_tiles;
  int* s_hits;
  int* s_reads;

  __device__ __forceinline__ uint2* entries_of(int r) const {
    cg::cluster_group cluster = cg::this_cluster();
    return cluster.map_shared_rank(cache_e + (size_t)(r / kCluster) * K,
                                   r % kCluster);
  }
  __device__ __forceinline__ float* beta_of(int r) const {
    cg::cluster_group cluster = cg::this_cluster();
    return cluster.map_shared_rank(cache_beta + r / kCluster, r % kCluster);
  }

  // The bid (b1 - b2) + eps of row r on column j1: into its slot in every
  // block, or (tail) straight into this block's key.
  __device__ __forceinline__ void deliver(int r, float b1, int j1, float b2,
                                          float eps_e, uint2* slot,
                                          bool tail) const {
    const float bid = (b1 - b2) + eps_e;
    if (tail) {
      if (lane == 0 && j1 < m) atomicMax(&key[j1], bid_key(bid, r));
    } else if (lane < kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      *cluster.map_shared_rank(slot + r, lane) =
          make_uint2(__float_as_uint(bid), static_cast<unsigned>(j1));
    }
  }

  // Row r's top-2 by one warp over its whole domain: from the cache where
  // it answers, else read (refreshing the cache).
  __device__ __forceinline__ void row_top2(int r, float& b1, int& j1,
                                           float& b2) const {
    if constexpr (K > 0) {
      if (cache_top2<K>(entries_of(r), *beta_of(r), price, m, lane, b1, j1,
                        b2)) {
        if (lane == 0) atomicAdd(s_hits, 1);
        return;
      }
      Cands<2> c;
      c.clear();
      rows.walk(r, price, 0, rows.units(r), lane,
                [&](float bx, float x, int j) { c.take(bx, x, j); });
      refresh(r, c, b1, j1, b2);
      if (lane == 0) atomicAdd(s_reads, 1);
    } else {
      b1 = -INFINITY;
      b2 = -INFINITY;
      j1 = INT_MAX;
      rows.walk(r, price, 0, rows.units(r), lane,
                [&](float, float x, int j) { top2_take(b1, j1, b2, x, j); });
      top2_warp_redux(b1, j1, b2);
    }
  }

  // Merges a warp's candidate lists into row r's top-2 (b1, j1, b2) and
  // its cache: the candidates, the rest of its K entries emptied, beta.
  template <int L>
  __device__ __forceinline__ void refresh(int r, Cands<L>& c, float& b1,
                                          int& j1, float& b2) const {
    uint2* e = entries_of(r);
    float beta;
    const int taken = c.template pop<K>(
        m, b1, j1, b2, beta, [&](int k, float, float bx, int j) {
          e[k] = make_uint2(__float_as_uint(bx), static_cast<unsigned>(j));
        });
    if (lane >= taken && lane < K) e[lane] = make_uint2(0u, INT_MAX);
    if (lane == 0) *beta_of(r) = beta;
  }

  // The row pass of a sweep: each warp of the cluster its contiguous run
  // of rows [row0, row_end), one bidding row at a time by the whole warp.
  __device__ __forceinline__ void warp_row_pass(uint2* slot, int row0,
                                                int row_end,
                                                float eps_e) const {
    for (int base = row0; base < row_end; base += 32) {
      const int mine = base + lane;
      unsigned bidders = __ballot_sync(0xffffffffu,
                                       mine < row_end && !assigned[mine]);
      while (bidders) {
        const int r = base + __ffs(bidders) - 1;
        bidders &= bidders - 1;
        float b1, b2;
        int j1;
        row_top2(r, b1, j1, b2);
        deliver(r, b1, j1, b2, eps_e, slot, false);
      }
    }
  }

  // The split row pass for a sweep of at most kCluster * 32 bidding rows:
  // this block's bidding rows r % kCluster == rank (tail: every bidding
  // row), each read by as many warps as the count allows, over contiguous
  // shares of its domain. With the cache or the tail (kFused), the warps
  // find the block's bidding rows by a ballot over the flags and bid at
  // once where the cache answers; only the rest are listed and read. The
  // list's count alternates between two counters by sweep: the one of the
  // next sweep is cleared here, its last reader two barriers back.
  __device__ void split_row_pass(uint2* slot, float eps_e, bool tail,
                                 int sweep) const {
    const int first = tail ? 0 : rank;
    const int stride = tail ? 1 : kCluster;
    int count;
    if constexpr (kFused) {
      int* cnt = s_count + (sweep & 1);
      if (tid == 0) s_count[(sweep & 1) ^ 1] = 0;
      const int mine = (n - first + stride - 1) / stride;
      for (int base = warp * 32; base < mine; base += kThreads) {
        const int i = base + lane;
        unsigned bidders = __ballot_sync(
            0xffffffffu, i < mine && !assigned[first + stride * i]);
        while (bidders) {
          const int r = first + stride * (base + __ffs(bidders) - 1);
          bidders &= bidders - 1;
          bool hit = false;
          if constexpr (K > 0) {
            float b1, b2;
            int j1;
            hit = cache_top2<K>(entries_of(r), *beta_of(r), price, m, lane,
                                b1, j1, b2);
            if (hit) {
              deliver(r, b1, j1, b2, eps_e, slot, tail);
              if (lane == 0) atomicAdd(s_hits, 1);
            }
          }
          if (!hit && lane == 0) split_rows[atomicAdd(cnt, 1)] = r;
        }
      }
      __syncthreads();
      count = *cnt;
      if (tid == 0) atomicAdd(s_reads, count);
    } else {
      if (tid == 0) *s_count = 0;
      __syncthreads();
      for (int r = first + stride * tid; r < n; r += stride * kThreads) {
        if (!assigned[r]) split_rows[atomicAdd(s_count, 1)] = r;
      }
      __syncthreads();
      count = *s_count;
    }
    const int* todo = split_rows;
    // warps a row: the largest power of two w with w * count <= 32
    int per_row = kWarps;
    while (per_row > 1 && per_row * count > kWarps) per_row >>= 1;
    const int rows_per_round = kWarps / per_row;
    const int share = warp % per_row;
    for (int base = 0; base < count; base += rows_per_round) {
      const int k = base + warp / per_row;
      if (k < count) {
        const int r = todo[k];
        const int units = rows.units(r);
        const int len = (units + per_row - 1) / per_row;
        const int q0 = share * len, q1 = min(units, (share + 1) * len);
        if constexpr (K > 0) {
          Cands<2> c;
          c.clear();
          rows.walk(r, price, q0, q1, lane,
                    [&](float bx, float x, int j) { c.take(bx, x, j); });
          float b1, b2, beta;
          int j1;
          // this warp's candidates, then its bound, then empty entries
          const int at = warp * (K + 1);
          const int taken = c.template pop<K>(
              m, b1, j1, b2, beta, [&](int q, float x, float bx, int j) {
                list_v[at + q] = x;
                list_b[at + q] = bx;
                list_j[at + q] = j;
              });
          if (lane >= taken && lane <= K) {
            list_v[at + lane] = lane == taken ? beta : -INFINITY;
            list_j[at + lane] = static_cast<int>(kBound);
          }
        } else {
          float b1 = -INFINITY, b2 = -INFINITY;
          int j1 = INT_MAX;
          rows.walk(r, price, q0, q1, lane, [&](float, float x, int j) {
            top2_take(b1, j1, b2, x, j);
          });
          top2_warp_redux(b1, j1, b2);
          if (lane == 0) {
            part_b1[warp] = b1;
            part_b2[warp] = b2;
            part_j1[warp] = j1;
          }
        }
      }
      __syncthreads();
      // warp g merges the per_row partials of round row g
      const int k2 = base + warp;
      if (warp < rows_per_round && k2 < count) {
        const int r = todo[k2];
        float b1 = -INFINITY, b2 = -INFINITY;
        int j1 = INT_MAX;
        if constexpr (K > 0) {
          Cands<K + 1> c;
          c.clear();
          if (lane < per_row) {
            const int at = (warp * per_row + lane) * (K + 1);
#pragma unroll
            for (int i = 0; i <= K; ++i) {
              c.v[i] = list_v[at + i];
              c.x[i] = list_b[at + i];
              c.j[i] = static_cast<unsigned>(list_j[at + i]);
            }
          }
          refresh(r, c, b1, j1, b2);
        } else {
          if (lane < per_row) {
            const int w = warp * per_row + lane;
            b1 = part_b1[w];
            b2 = part_b2[w];
            j1 = part_j1[w];
          }
          top2_warp_redux(b1, j1, b2);
        }
        deliver(r, b1, j1, b2, eps_e, slot, tail);
      }
      __syncthreads();
    }
  }

  // Columns: take the winning bid, seat the winner, free the old owner;
  // old owners and new winners are disjoint (owners do not bid). Counts
  // and clears the flags of the row tiles that bid.
  __device__ __forceinline__ void column_pass() const {
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
          atomicAdd(s_owned, 1);
        }
        c2r[j] = winner;
        assigned[winner] = 1;
      }
    }
    if constexpr (Rows::kBand) {
      for (int t = tid; t < ntiles; t += kThreads) {
        if (tile_flag[t]) {
          tile_flag[t] = 0;
          atomicAdd(s_tiles, 1);
        }
      }
    }
  }

  // Banded rows with `carry`, at the start of a later phase: unseat the
  // rows whose held column's value is below their window's best - eps
  // (every block holds the previous phase's final state). The decision
  // goes to every block through the rows' slots of buffer 0.
  __device__ void unseat_pass(int row0, int row_end, float eps_e) {
    cg::cluster_group cluster = cg::this_cluster();
    // the rows' held columns, in the key memory (zero between sweeps)
    int* held = reinterpret_cast<int*>(key);
    for (int j = tid; j < m; j += kThreads) {
      if (c2r[j] >= 0) held[c2r[j]] = j;
    }
    __syncthreads();
    for (int base = row0; base < row_end; base += 32) {
      const int mine = base + lane;
      unsigned seated = __ballot_sync(0xffffffffu,
                                      mine < row_end && assigned[mine]);
      while (seated) {
        const int r = base + __ffs(seated) - 1;
        seated &= seated - 1;
        float b1, b2;
        int j1;
        row_top2(r, b1, j1, b2);
        const int h = held[r];
        const float cur = rows.value(r, h) - price[h];
        if (lane < kCluster) {
          *cluster.map_shared_rank(slots + r, lane) =
              make_uint2(cur < b1 - eps_e ? 1u : 0u,
                         static_cast<unsigned>(h));
        }
      }
    }
    cluster.sync();
    for (int r = tid; r < n; r += kThreads) {
      if (assigned[r] && slots[r].x) {
        assigned[r] = 0;
        c2r[slots[r].y] = -1;
        atomicSub(s_owned, 1);
      }
    }
    for (int j = tid; j < m; j += kThreads) key[j] = 0ull;
    // every block has read its slots before the first sweep stores again
    cluster.sync();
  }
};

// The whole solve of element blockIdx.x / kCluster, whose rows are `rows`.
// `carry` and `tile` are the banded rows' (whose target points are copied
// into shared memory when rows.smem_points() > 0) and ignored otherwise.
// probe, when not null, gets per element (+=) the bids the cache answered
// and the rows read.
template <int kCluster, class Rows, bool kSplit, int kCacheK, bool kTail>
__device__ __forceinline__ void cluster_solve(
    Rows rows, const float* __restrict__ price_in, int n, int m, EpsList eps,
    int max_sweeps, int nbuf, int carry, int tile,
    long long* __restrict__ row_to_col, float* __restrict__ price_out,
    int* __restrict__ stats, int* __restrict__ probe) {
  using Solver = ClusterSolver<kCluster, Rows, kSplit, kCacheK, kTail>;
  constexpr int kThreads = kClusterThreads;
  constexpr int kWarps = kClusterWarps;
  constexpr int K = kCacheK;
  constexpr int kStatCols = Solver::kStatCols;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_owned, s_count[2], s_tiles, s_hits, s_reads;

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / kCluster;
  const int ntiles = Rows::kBand ? n / tile : 0;
  const ClusterLayout l = cluster_layout(n, m, nbuf, kSplit, K, kCluster,
                                         rows.smem_points(), ntiles);
  Solver s;
  s.rows = rows;
  s.n = n;
  s.m = m;
  s.rank = static_cast<int>(cluster.block_rank());
  s.tid = threadIdx.x;
  s.lane = threadIdx.x & 31;
  s.warp = threadIdx.x >> 5;
  s.key = reinterpret_cast<unsigned long long*>(smem);
  s.slots = reinterpret_cast<uint2*>(smem + l.slots);
  s.price = reinterpret_cast<float*>(smem + l.price);
  s.c2r = reinterpret_cast<int*>(smem + l.c2r);
  s.assigned = smem + l.assigned;
  s.split_rows = reinterpret_cast<int*>(smem + l.split);
  s.part_b1 = reinterpret_cast<float*>(s.split_rows + kSplitRowsMax);
  s.part_b2 = s.part_b1 + kWarps;
  s.part_j1 = reinterpret_cast<int*>(s.part_b2 + kWarps);
  s.list_v = reinterpret_cast<float*>(smem + l.cache);
  s.list_b = s.list_v + kWarps * (K + 1);
  s.list_j = reinterpret_cast<int*>(s.list_b + kWarps * (K + 1));
  s.cache_e = reinterpret_cast<uint2*>(s.list_j + kWarps * (K + 1));
  s.cache_beta = reinterpret_cast<float*>(
      s.cache_e + (size_t)((n + kCluster - 1) / kCluster) * K);
  s.tile_flag = smem + l.tiles;
  s.tile = tile;
  s.ntiles = ntiles;
  s.s_owned = &s_owned;
  s.s_count = s_count;
  s.s_tiles = &s_tiles;
  s.s_hits = &s_hits;
  s.s_reads = &s_reads;
  const int rank = s.rank;
  const int tid = s.tid;
  // the rows of this warp of the cluster: [row0, row_end)
  const int per_warp = (n + kCluster * kWarps - 1) / (kCluster * kWarps);
  const int row0 = (rank * kWarps + (tid >> 5)) * per_warp;
  const int row_end = min(n, row0 + per_warp);

  for (int j = tid; j < m; j += kThreads) {
    s.price[j] = price_in[(size_t)b * m + j];
    s.key[j] = 0ull;
  }
  if constexpr (Rows::kBand) {
    if (rows.smem_points() > 0) {
      float* t = reinterpret_cast<float*>(smem + l.tgt);
      for (int i = tid; i < 3 * m; i += kThreads) t[i] = rows.tgt[i];
      s.rows.tgt = t;
    }
    for (int t = tid; t < ntiles; t += kThreads) s.tile_flag[t] = 0;
  }
  if constexpr (K > 0) {
    // no row has been read: every cache refuses
    for (int r = tid; r < (n + kCluster - 1) / kCluster; r += kThreads) {
      s.cache_beta[r] = INFINITY;
    }
  }
  if (tid == 0) {
    s_hits = 0;
    s_reads = 0;
  }
  // every block has started before a bid is stored into it
  cluster.sync();

  for (int e = 0; e < eps.n; ++e) {
    const float eps_e = eps.v[e];
    if (tid == 0) {
      s_tiles = 0;
      s_count[0] = s_count[1] = 0;
    }
    bool fresh = true;
    if constexpr (Rows::kBand) {
      if (carry && e > 0) {
        s.unseat_pass(row0, row_end, eps_e);
        fresh = false;
      }
    }
    if (fresh) {
      for (int j = tid; j < m; j += kThreads) s.c2r[j] = -1;
      for (int r = tid; r < n; r += kThreads) s.assigned[r] = 0;
      if (tid == 0) s_owned = 0;
      __syncthreads();
    }

    int sweep = 0;
    int bid_rows = 0;  // the stats: rows that bid in this phase
    bool tail = false;
    for (; s_owned < n && sweep < max_sweeps; ++sweep) {
      const int bidders = n - s_owned;  // the same in every block
      if (kTail && bidders <= kTailRows) {
        tail = true;
        break;
      }
      bid_rows += bidders;
      uint2* slot = s.slots + (sweep % nbuf) * n;
      if (kSplit && bidders <= kCluster * kWarps) {
        s.split_row_pass(slot, eps_e, false, sweep);
      } else {
        s.warp_row_pass(slot, row0, row_end, eps_e);
      }
      cluster.sync();
      // every block folds the bids of the rows without a column (every
      // such row bid this sweep) into its column keys
      for (int r = tid; r < n; r += kThreads) {
        if (!s.assigned[r]) {
          const uint2 sl = slot[r];
          if (sl.y < static_cast<unsigned>(m)) {
            atomicMax(&s.key[sl.y], bid_key(__uint_as_float(sl.x), r));
          }
          if constexpr (Rows::kBand) s.tile_flag[r / tile] = 1;
        }
      }
      __syncthreads();
      s.column_pass();
      if (nbuf == 2) {
        __syncthreads();
      } else {
        cluster.sync();
      }
    }
    if (kTail && tail && rank == 0) {
      // the rest of the phase on this block alone
      for (; s_owned < n && sweep < max_sweeps; ++sweep) {
        bid_rows += n - s_owned;
        s.split_row_pass(nullptr, eps_e, true, sweep);
        s.column_pass();
        __syncthreads();
      }
      // the next phase starts from these prices in every block
      for (int k = 1; k < kCluster; ++k) {
        float* p = cluster.map_shared_rank(s.price, k);
        for (int j = tid; j < m; j += kThreads) p[j] = s.price[j];
      }
    }
    if constexpr (kSplit) {
      if (rank == 0 && tid == 0) {
        int* st = stats + ((size_t)b * eps.n + e) * kStatCols;
        st[0] = sweep;
        st[1] = bid_rows;
        if constexpr (Rows::kBand) st[2] = s_tiles;
      }
    }
    // every block ends the phase here: the next phase's sweeps start their
    // slot buffers afresh, and every thread has read s_owned for the exit
    // test before the next phase resets it
    cluster.sync();
  }

  // every block holds the same result; block 0 writes the owners
  if constexpr (Rows::kBand) {
    // each row left at the bound on its best column under the final
    // prices, by the cluster's warps
    for (int base = row0; base < row_end; base += 32) {
      const int mine = base + s.lane;
      unsigned left = __ballot_sync(0xffffffffu,
                                    mine < row_end && !s.assigned[mine]);
      while (left) {
        const int r = base + __ffs(left) - 1;
        left &= left - 1;
        float b1, b2;
        int j1;
        s.row_top2(r, b1, j1, b2);
        if (s.lane == 0) row_to_col[(size_t)b * n + r] = j1;
      }
    }
    // no block leaves while another may read its cache
    cluster.sync();
  }
  if (rank == 0) {
    if constexpr (!Rows::kBand) {
      for (int r = tid; r < n; r += kThreads) {
        row_to_col[(size_t)b * n + r] = -1;
      }
      __syncthreads();
    }
    for (int j = tid; j < m; j += kThreads) {
      const int owner = s.c2r[j];
      if (owner >= 0) row_to_col[(size_t)b * n + owner] = j;
      price_out[(size_t)b * m + j] = s.price[j];
    }
  }
  if constexpr (K > 0) {
    __syncthreads();
    if (probe != nullptr && tid == 0) {
      atomicAdd(probe + 2 * b, s_hits);
      atomicAdd(probe + 2 * b + 1, s_reads);
    }
  }
}

}  // namespace auction
