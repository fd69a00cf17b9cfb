// The two matrix-shaped passes of one Jacobi auction sweep, for problems
// past the resident kernel's window (auction.cu holds N*M <= 1024^2).
//
// Replaces reart_tpu/ops/pallas_auction.py: row_top2_pallas /
// _row_top2_kernel and col_winner_max_pallas / _col_winner_kernel.
//
// row_top2: benefit (B, N, M), price (B, M), float32 ->
//   best_v (B, N):   max over columns of benefit - price;
//   second_v (B, N): max over the other columns (-inf when M == 1);
//   best_j (B, N):   int64 column of best_v, the lowest among equals.
// col_winner_max: bid (B, N) float32 (-inf for rows that do not bid),
// best_j (B, N) int64 ->
//   col_bid (B, M):    the largest bid on each column, -inf where none;
//   col_winner (B, M): int64 row of that bid, the lowest among equals, 0
//                      where no row bid.
//
// What bounds them on an H100: row_top2 reads the benefit matrix once per
// sweep (9 x 4096^2 float32 = 604 MB) and does two flops per entry, so it
// is bound by device memory; col_winner_max touches only the (B, N) bids
// and (B, M) outputs, a few hundred KB, and its launch is the cost.
//
// Design. row_top2: one warp per row; a lane walks its columns in ascending
// order (coalesced 128-byte reads) with a running (best, column, second) in
// registers, strict '>' so the lowest column wins a tie, and the 32 lanes
// merge by shuffles with the same rule. The TPU kernel's running merge
// across column tiles in revisited output blocks is not carried over: a
// warp sees its whole row. col_winner_max: the bid matrix is one-hot per
// row, so the TPU kernel's (TN, TM) masked tile maximum becomes a scatter:
// each bidding row does one 64-bit atomicMax in shared memory on a key of
// (order-preserving bid bits, ~row), which yields the largest bid and,
// among equals, the lowest row whatever the order of arrival; one block
// owns a tile of columns and scans all rows, so no global atomics and no
// zero-initialised buffer are needed.

#include "auction_common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each
constexpr int kColTile = 2048;    // columns per block of col_winner_max
constexpr int kColThreads = 256;

struct Top2 {
  float best, second;
  int col;
};

// `b` joins `a`; the two cover disjoint columns.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  Top2 out;
  if (b.best > a.best || (b.best == a.best && b.col < a.col)) {
    out.best = b.best;
    out.col = b.col;
    out.second = fmaxf(a.best, b.second);
  } else {
    out.best = a.best;
    out.col = a.col;
    out.second = fmaxf(a.second, b.best);
  }
  return out;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_top2_kernel(const float* __restrict__ benefit,
                const float* __restrict__ price, long long rows, int n, int m,
                float* __restrict__ best_v, float* __restrict__ second_v,
                long long* __restrict__ best_j) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;  // a whole warp leaves together
  const float* v = benefit + row * m;
  const float* p = price + (row / n) * m;
  Top2 t{-INFINITY, -INFINITY, INT32_MAX};
  for (int j = threadIdx.x; j < m; j += 32) {
    const float x = v[j] - p[j];
    if (x > t.best) {
      t.second = t.best;
      t.best = x;
      t.col = j;
    } else if (x > t.second) {
      t.second = x;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_down_sync(0xffffffffu, t.best, off);
    o.second = __shfl_down_sync(0xffffffffu, t.second, off);
    o.col = __shfl_down_sync(0xffffffffu, t.col, off);
    t = merge(t, o);
  }
  if (threadIdx.x == 0) {
    best_v[row] = t.best;
    second_v[row] = t.second;
    best_j[row] = t.col;
  }
}

__global__ void __launch_bounds__(kColThreads)
col_winner_kernel(const float* __restrict__ bid,
                  const long long* __restrict__ best_j, int n, int m,
                  float* __restrict__ col_bid,
                  long long* __restrict__ col_winner) {
  __shared__ unsigned long long key[kColTile];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kColTile;
  const int cnt = min(kColTile, m - c0);
  for (int c = threadIdx.x; c < cnt; c += blockDim.x) key[c] = 0ull;
  __syncthreads();
  const float* bb = bid + (size_t)b * n;
  const long long* bj = best_j + (size_t)b * n;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float x = bb[r];
    const long long c = bj[r] - c0;
    if (x > -INFINITY && c >= 0 && c < cnt) {
      atomicMax(&key[c], auction::bid_key(x, r));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cnt; c += blockDim.x) {
    const unsigned long long k = key[c];
    const size_t o = (size_t)b * m + c0 + c;
    if (k == 0ull) {
      col_bid[o] = -INFINITY;
      col_winner[o] = 0;
    } else {
      col_bid[o] = auction::key_bid(k);
      col_winner[o] = auction::key_row(k);
    }
  }
}

}  // namespace

extern "C" int reart_row_top2(const float* benefit, const float* price,
                              int batch, int n, int m, float* best_v,
                              float* second_v, long long* best_j,
                              void* stream) {
  const long long rows = (long long)batch * n;
  const dim3 block(32, kRowsPerBlock);
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  row_top2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      benefit, price, rows, n, m, best_v, second_v, best_j);
  return static_cast<int>(cudaGetLastError());
}

// batch <= 65,535 (gridDim.y)
extern "C" int reart_col_winner_max(const float* bid, const long long* best_j,
                                    int batch, int n, int m, float* col_bid,
                                    long long* col_winner, void* stream) {
  const dim3 grid((m + kColTile - 1) / kColTile, batch);
  col_winner_kernel<<<grid, kColThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      bid, best_j, n, m, col_bid, col_winner);
  return static_cast<int>(cudaGetLastError());
}
