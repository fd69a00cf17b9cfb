// Banded epsilon-scaled Jacobi auction straight from curve-sorted points:
// the whole LAP solve of a giant problem in one launch, without a benefit
// matrix.
//
// Replaces reart_tpu/ops/pallas_auction.py: auction_solve_banded /
// _banded_kernel. For src (B, N, 3) and tgt (B, M, 3) float32, both sorted
// along a space-filling curve, N == M in the fit, and prices (B, M): row
// tile t (rows t*tile .. t*tile + tile - 1) bids only inside its window of
// w sorted columns starting at o_t = min(max(t*tile + tile/2 - w/2, 0),
// m - w). The benefit of (i, j) is -sqrt(((0 + dx^2) + dy^2) + dz^2) of the
// points, recomputed where it is needed. Each epsilon phase of
// eps[0..n_eps) (high to low) sweeps until every row owns a column or
// max_sweeps is reached: a row without a column bids (v1 - v2) + eps on its
// best column of v = benefit - price over its window (lowest column on
// ties), each column takes its highest bid (lowest row on ties), adds it to
// its price and changes owner. A phase restarts from no owners, or with
// `carry` keeps the previous phase's owners and unseats only the rows that
// break epsilon-complementary slackness at the new epsilon (value of the
// held column < best value in the window - eps). At the end a row left
// without a column takes its best in-band column under the final prices.
// Writes row_to_col (B, N) int64 in sorted column indices, the final
// prices, and per element and phase the sweeps run, the rows that bid and
// the row tiles that bid (stats (B, n_eps, 3) int32, zeroed by the caller).
//
// What bounds it on an H100: arithmetic. The band's distances are
// N * w * 9 operations per element (sapien: 4096 x 1024 x 7 elements,
// 264 M), recomputed for every row that bids in a sweep; the bytes (points,
// prices, the row map) are about 1 MB. The TPU kernel kept the (N, w) band
// in VMEM; here that is 16 MB per element, more than a block's shared
// memory and, for 7 elements, more than the 50 MB L2, so a bidding row
// recomputes its w distances from the points (12 KB of target points per
// element, which stay in L1 and L2).
//
// Design: the one-launch scheme of auction_hbm.cu. One element's sweep is
// spread over a thread-block cluster of 8 blocks of 1024 threads (7 x 8 = 56
// blocks at the sapien shape), and convergence is decided on the device.
//   * Row pass: the cluster's 256 warps share the rows; a warp takes a row
//     without a column, its lanes walk the row's window in ascending column
//     order against a copy of the prices in shared memory, the shuffle merge
//     of auction_common.cuh gives the top two, and lane 0 posts one 64-bit
//     atomicMax on the column's bid key (bid bits, then the inverted row),
//     which merges the overlapping windows of neighbouring tiles. A tile
//     whose rows all own a column bids nothing, so it costs nothing: the
//     TPU kernel's converged-tile skip is the per-row test here.
//   * cluster.sync()
//   * Column pass: the cluster's 8192 threads share the columns, a column
//     always with the same thread; a column with a bid adds it to its price,
//     frees its old owner, seats the winner and clears its key. Old owners
//     and winners are disjoint (owners do not bid).
//   * cluster.sync(), then every block reads the owned count and the prices.
// The row map r2c, the owner map c2r, prices, bid keys, the tile flags and
// the owned count live in global memory; what another block wrote is read
// with __ldcg, past the SM's own L1. Built with -fmad=false and IEEE sqrt,
// so each value rounds as in the plain PyTorch version.

#include <cooperative_groups.h>

#include "auction_common.cuh"

namespace cg = cooperative_groups;

namespace {

using auction::EpsList;

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = kCluster * kThreads;
constexpr int kWarpStride = kCluster * kWarps;

struct Band {
  int n, m, w, tile;
};

__device__ __forceinline__ int band_offset(int t, const Band& bd) {
  const int o = max(t * bd.tile + bd.tile / 2 - bd.w / 2, 0);
  return min(o, bd.m - bd.w);
}

// benefit - price of row point (sx, sy, sz) against sorted column j
__device__ __forceinline__ float band_value(float sx, float sy, float sz,
                                            const float* __restrict__ tgt,
                                            const float* price, int j) {
  const float dx = sx - __ldg(tgt + 3 * j);
  const float dy = sy - __ldg(tgt + 3 * j + 1);
  const float dz = sz - __ldg(tgt + 3 * j + 2);
  float acc = 0.0f + dx * dx;
  acc = acc + dy * dy;
  acc = acc + dz * dz;
  return -__fsqrt_rn(acc) - price[j];
}

// Top-2 of row r's window by one warp; the result is lane 0's (all lanes
// hold it after the merge's last step only on lane 0).
__device__ __forceinline__ void band_top2(const float* __restrict__ src,
                                          const float* __restrict__ tgt,
                                          const float* price, int r, int o,
                                          int w, int lane, float& b1, int& j1,
                                          float& b2) {
  const float sx = __ldg(src + 3 * r);
  const float sy = __ldg(src + 3 * r + 1);
  const float sz = __ldg(src + 3 * r + 2);
  b1 = -INFINITY;
  b2 = -INFINITY;
  j1 = INT_MAX;
#pragma unroll 4
  for (int j = lane; j < w; j += 32) {
    auction::top2_take(b1, j1, b2, band_value(sx, sy, sz, tgt, price, o + j),
                       o + j);
  }
  auction::top2_warp_merge(b1, j1, b2);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
auction_banded_kernel(const float* __restrict__ src,
                      const float* __restrict__ tgt,
                      const float* __restrict__ price_in, Band bd,
                      EpsList eps, int max_sweeps, int carry,
                      long long* __restrict__ row_to_col, float* price,
                      unsigned long long* key, int* c2r, int* r2c,
                      int* tile_flag, int* owned, int* __restrict__ stats) {
  extern __shared__ __align__(16) float s_price[];  // (M,)
  __shared__ int s_owned;
  __shared__ int s_bidders;
  __shared__ int s_tiles;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cwarp = rank * kWarps + (tid >> 5);  // warp of the cluster
  const int cthread = rank * kThreads + tid;     // thread of the cluster
  const int n = bd.n, m = bd.m, w = bd.w, tile = bd.tile;
  const int ntiles = n / tile;
  src += (size_t)b * n * 3;
  tgt += (size_t)b * m * 3;
  price_in += (size_t)b * m;
  price += (size_t)b * m;
  key += (size_t)b * m;
  c2r += (size_t)b * m;
  r2c += (size_t)b * n;
  tile_flag += (size_t)b * ntiles;
  owned += b;
  row_to_col += (size_t)b * n;
  stats += (size_t)b * eps.n * 3;

  for (int j = cthread; j < m; j += kStride) price[j] = price_in[j];
  for (int t = cthread; t < ntiles; t += kStride) tile_flag[t] = 0;

  for (int e = 0; e < eps.n; ++e) {
    const float eps_e = eps.v[e];
    if (tid == 0) {
      s_bidders = 0;
      s_tiles = 0;
    }
    if (!carry || e == 0) {
      for (int j = cthread; j < m; j += kStride) {
        c2r[j] = -1;
        key[j] = 0ull;
      }
      for (int r = cthread; r < n; r += kStride) r2c[r] = -1;
      if (cthread == 0) *owned = 0;
    } else {
      // unseat the rows that break eps-CS at the new epsilon: the prices
      // and owners of the previous phase are final (cluster.sync below it)
      for (int j = tid; j < m; j += kThreads) s_price[j] = __ldcg(price + j);
      __syncthreads();
      for (int r = cwarp; r < n; r += kWarpStride) {
        const int held = __ldcg(r2c + r);
        if (held < 0) continue;
        const int o = band_offset(r / tile, bd);
        float b1, b2;
        int j1;
        band_top2(src, tgt, s_price, r, o, w, lane, b1, j1, b2);
        if (lane == 0) {
          const float cur = band_value(__ldg(src + 3 * r),
                                       __ldg(src + 3 * r + 1),
                                       __ldg(src + 3 * r + 2), tgt, s_price,
                                       held);
          if (cur < b1 - eps_e) {
            r2c[r] = -1;
            c2r[held] = -1;
            atomicSub(owned, 1);
          }
        }
      }
    }
    cluster.sync();

    int sweep = 0;
    for (; sweep < max_sweeps; ++sweep) {
      if (tid == 0) s_owned = __ldcg(owned);
      for (int j = tid; j < m; j += kThreads) s_price[j] = __ldcg(price + j);
      __syncthreads();
      // the same count in every block of the cluster: all leave together
      if (s_owned >= n) break;

      // bids: one warp per row without a column
      for (int r = cwarp; r < n; r += kWarpStride) {
        if (__ldcg(r2c + r) >= 0) continue;
        const int t = r / tile;
        float b1, b2;
        int j1;
        band_top2(src, tgt, s_price, r, band_offset(t, bd), w, lane, b1, j1,
                  b2);
        if (lane == 0) {
          atomicMax(&key[j1], auction::bid_key((b1 - b2) + eps_e, r));
          atomicAdd(&s_bidders, 1);
          __stcg(tile_flag + t, 1);
        }
      }
      cluster.sync();
      // columns: take the winning bid, seat the winner, free the old owner
      for (int j = cthread; j < m; j += kStride) {
        const unsigned long long k = __ldcg(key + j);
        if (k != 0ull) {
          const int winner = auction::key_row(k);
          price[j] = __ldcg(price + j) + auction::key_bid(k);
          const int old = __ldcg(c2r + j);
          if (old >= 0) {
            r2c[old] = -1;
          } else {
            atomicAdd(owned, 1);
          }
          c2r[j] = winner;
          r2c[winner] = j;
          key[j] = 0ull;
        }
      }
      for (int t = cthread; t < ntiles; t += kStride) {
        if (__ldcg(tile_flag + t)) {
          tile_flag[t] = 0;
          atomicAdd(&s_tiles, 1);
        }
      }
      cluster.sync();
    }
    __syncthreads();
    if (tid == 0) {
      atomicAdd(stats + 3 * e + 1, s_bidders);
      atomicAdd(stats + 3 * e + 2, s_tiles);
      if (rank == 0) stats[3 * e] = sweep;
    }
    // every block is past its last read of the owned count before the next
    // phase resets or changes it
    cluster.sync();
  }

  // the row map, with each row left at the bound on its best in-band column
  // under the final prices
  for (int j = tid; j < m; j += kThreads) s_price[j] = __ldcg(price + j);
  __syncthreads();
  for (int r = cwarp; r < n; r += kWarpStride) {
    const int held = __ldcg(r2c + r);
    if (held >= 0) {
      if (lane == 0) row_to_col[r] = held;
      continue;
    }
    float b1, b2;
    int j1;
    band_top2(src, tgt, s_price, r, band_offset(r / tile, bd), w, lane, b1,
              j1, b2);
    if (lane == 0) row_to_col[r] = j1;
  }
}

}  // namespace

// scratch, all written before read: key (B, M) uint64, c2r (B, M), r2c
// (B, N), tile_flag (B, N / tile), owned (B,) int32. price_out doubles as
// the working prices. stats (B, n_eps, 3) int32 must come in zeroed.
extern "C" int reart_auction_banded(
    const float* src, const float* tgt, const float* price_in, int batch,
    int n, int m, int w, int tile, const float* eps, int n_eps,
    int max_sweeps, int carry, long long* row_to_col, float* price_out,
    unsigned long long* key, int* c2r, int* r2c, int* tile_flag, int* owned,
    int* stats, void* stream) {
  if (n_eps < 1 || n_eps > auction::kMaxEps || batch < 1 || n < 1 ||
      m < 1 || w < 1 || w > m || tile < 1 || n % tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpsList list{};
  for (int e = 0; e < n_eps; ++e) list.v[e] = eps[e];
  list.n = n_eps;
  const Band bd{n, m, w, tile};
  const size_t smem = 4 * (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      auction_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_banded_kernel<<<batch * kCluster, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      src, tgt, price_in, bd, list, max_sweeps, carry, row_to_col, price_out,
      key, c2r, r2c, tile_flag, owned, stats);
  return static_cast<int>(cudaGetLastError());
}
