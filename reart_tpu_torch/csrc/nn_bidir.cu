// Bidirectional 1-NN without coordinates.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn_bidir_pallas / _bidir_kernel. For
// src (B, N, 3) and tgt (B, M, 3), float32:
//   forward (per src point): squared distance to and int64 index of its
//           nearest tgt point -> fd (B, N), fi (B, N);
//   reverse (per tgt point): the same against src -> bd (B, M), bi (B, M).
// Distances are (dx^2 + dy^2) + dz^2 of src - tgt; ties go to the lowest
// index. This is the Chamfer metric's search: both directions of
// compute_chamfer_list in one call.
//
// What bounds it on an H100: float32 instruction rate. Every (src, tgt)
// pair is 8 float operations (-fmad=false: no FMA) and two minima, one for
// its row and one for its column: 10 instructions a pair. At (9, 4096,
// 4096) that is 151M pairs, 0.0451 ms on 132 SMs x 128 lanes at 1.98 GHz;
// the clouds and outputs are a few MB.
//
// Design (the wrapper picks W, L and the grid: ops/cuda_nn.nn_bidir_plan):
//   * One pass over the (N, M) plane, each distance once, reduced along
//     both axes, as the TPU kernel does. The plane is cut into units: a
//     row block of W x RT consecutive src rows (W warps, 1-8; RT = 16 a
//     warp) against a chunk of 32 L tgt columns. The grid
//     is the blocks the card holds at once, and block i takes units
//     [i U / G, (i + 1) U / G) in (cloud, row block, chunk) order, so every
//     block has the same work to within one unit, whatever the shape. A
//     chunk is staged in shared memory by cp.async, the next one in flight
//     while the current one is scanned.
//   * Every lane of a warp holds the warp's RT rows in registers, and walks
//     its own L consecutive columns of the chunk: one staged point serves
//     RT pairs. Each distance feeds two fminf: its row's minimum over the
//     lane's L columns (a column group), and its column's minimum over the
//     warp's RT rows (a row group). No index is selected per pair.
//   * Rows: a lane's running best (value, group) of a row is replaced only
//     by a strictly smaller group minimum, so the group recorded is the
//     first that holds the best value (the k = 1 rule of nn_topk.cu).
//     When the block's row block changes, and at its end, the 32 lanes'
//     (value, group) keys of each row merge by shuffles, one halving of the
//     rows a step.
//   * Columns: each lane stores its column minima in shared memory; after
//     the chunk one thread a column takes the smallest over the W warps in
//     ascending order with a strict '<', so (value, warp) names the first
//     row group that holds the column's minimum.
//   * Across blocks: a 64-bit atomicMin a row and a column on
//     key = (float bits << 32) | group. Distances are never negative, so
//     keys order as (distance, group) and the smallest key is the first
//     group holding the minimum, whatever the order of arrival
//     (nn_split.cuh). Groups are runs of consecutive indices in index
//     order, so that group holds the lowest index at the minimum.
//   * Decode: one thread an output recomputes its group's L (or RT)
//     distances in the scan's order and takes the first equal to the key's
//     value, which is the distance itself, exactly.
// Rows past N and columns past M are NaN points: fminf passes over a NaN,
// so they never win. A call makes four device launches: two memsets of the
// key buffers to all ones, the scan and the decode. Built with -fmad=false
// so every sum rounds as the plain version's.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "nn_split.cuh"

namespace {

using nn_split::Key;

constexpr int kRT = 16;                   // src rows a warp holds, each
                                          // lane all of them
constexpr int kMaxWarps = 8;
constexpr int kMaxRun = 16;               // L: columns of a lane a chunk
constexpr int kStride = kMaxRun + 1;      // a lane's run in shared memory,
                                          // padded: no bank conflicts
constexpr int kSlots = 32 * kStride;      // a chunk's places
constexpr unsigned kFull = 0xffffffffu;

// the place of chunk column e: lane e / run, step e % run
__device__ __forceinline__ int place(int e, int run) {
  return (e / run) * kStride + e % run;
}

// k[r] is this lane's key of row r. Returns the smallest key of row
// lane / (32 / R) over the 32 lanes: each step halves the rows a lane keeps
// and merges them with the partner lane's, the last steps merge whole keys.
template <int R>
__device__ __forceinline__ Key rows_min(Key (&k)[R], int lane) {
#pragma unroll
  for (int half = R / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const Key send = up ? k[i] : k[i + half];
      const Key keep = up ? k[i + half] : k[i];
      k[i] = nn_split::key_min(keep, __shfl_xor_sync(kFull, send, off));
    }
  }
  Key out = k[0];
#pragma unroll
  for (int off = 16 / R; off >= 1; off /= 2)
    out = nn_split::key_min(out, __shfl_xor_sync(kFull, out, off));
  return out;
}

// Merge the held rows' (best, group) keys over the warp's lanes and post
// them: row block seg % rblk of cloud seg / rblk.
__device__ __forceinline__ void post_rows(const float (&best)[kRT],
                                          const int (&grp)[kRT],
                                          long long seg, int rblk, int warps,
                                          int n, Key* __restrict__ fkey) {
  const int lane = threadIdx.x & 31;
  Key key[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) key[r] = nn_split::make_key(best[r], grp[r]);
  const Key k = rows_min<kRT>(key, lane);
  constexpr int kLanesARow = 32 / kRT;
  const int row = ((int)(seg % rblk) * warps + (threadIdx.x >> 5)) * kRT +
                  lane / kLanesARow;
  if (lane % kLanesARow == 0 && row < n)
    atomicMin(&fkey[(size_t)(seg / rblk) * n + row], k);
}

__global__ void __launch_bounds__(32 * kMaxWarps, 2)
nn_bidir_scan_kernel(const float* __restrict__ src,
                     const float* __restrict__ tgt, int n, int m, int run,
                     int chunks, int rblk, long long units,
                     Key* __restrict__ fkey, Key* __restrict__ bkey) {
  __shared__ __align__(16) float4 s_pts[2][kSlots];
  __shared__ float s_col[kMaxWarps][kSlots];

  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = 32 * run;  // columns a chunk
  // this block's units: unit u is chunk u % chunks of row block
  // (u / chunks) % rblk of cloud u / chunks / rblk
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;

  float sx[kRT], sy[kRT], sz[kRT], best[kRT];
  int grp[kRT];
  long long seg = -1;  // the (cloud, row block) whose rows are held

  // Stage chunk c of cloud b into `buf`; columns past M are NaN points.
  auto stage = [&](long long u, float4* buf) {
    const int c0 = (int)(u % chunks) * chunk;
    const float* tp = tgt + (size_t)(u / chunks / rblk) * m * 3;
    for (int e = threadIdx.x; e < chunk; e += blockDim.x) {
      float* dst = reinterpret_cast<float*>(buf + place(e, run));
      if (c0 + e < m) {
        const float* p = tp + 3 * (size_t)(c0 + e);
        cp_async::copy4(dst, p);
        cp_async::copy4(dst + 1, p + 1);
        cp_async::copy4(dst + 2, p + 2);
      } else {
        dst[0] = dst[1] = dst[2] = NAN;
      }
    }
    cp_async::commit();
  };

  if (u0 < u1) stage(u0, s_pts[0]);
  for (long long u = u0; u < u1; ++u) {
    const int c = (int)(u % chunks);
    const int rb = (int)(u / chunks % rblk);
    const int b = (int)(u / chunks / rblk);
    if (u / chunks != seg) {  // a new row block: post the old, load it
      if (seg >= 0) post_rows(best, grp, seg, rblk, warps, n, fkey);
      seg = u / chunks;
      const int r0 = (rb * warps + warp) * kRT;
      const float* sp = src + (size_t)b * n * 3;
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        sx[r] = sy[r] = sz[r] = NAN;
        if (r0 + r < n) {
          sx[r] = sp[3 * (r0 + r)];
          sy[r] = sp[3 * (r0 + r) + 1];
          sz[r] = sp[3 * (r0 + r) + 2];
        }
        best[r] = INFINITY;
        grp[r] = c * 32 + lane;  // the lane's first group here
      }
    }
    // this chunk's copies have landed and are visible; every thread is
    // past the previous chunk's column merge, so s_col and the other
    // buffer may be refilled
    cp_async::wait_all();
    __syncthreads();
    if (u + 1 < u1) stage(u + 1, s_pts[(u - u0 + 1) & 1]);

    const float4* pts = s_pts[(u - u0) & 1] + lane * kStride;
    float* cols = s_col[warp] + lane * kStride;
    float tm[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) tm[r] = INFINITY;
#pragma unroll 4
    for (int k = 0; k < run; ++k) {
      const float4 p = pts[k];
      float cm = INFINITY;
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float d = nn_split::sqdist(sx[r], sy[r], sz[r], p.x, p.y, p.z);
        tm[r] = fminf(tm[r], d);
        cm = fminf(cm, d);
      }
      cols[k] = cm;
    }
    const int g = c * 32 + lane;  // this lane's column group
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      if (tm[r] < best[r]) {
        best[r] = tm[r];
        grp[r] = g;
      }
    }
    __syncthreads();  // every warp's column minima of the chunk are stored

    // one thread a column: the first warp (row group) at the minimum
    const int c0 = c * chunk;
    for (int e = threadIdx.x; e < chunk && c0 + e < m; e += blockDim.x) {
      const int q = place(e, run);
      float v = s_col[0][q];
      int w = 0;
      for (int x = 1; x < warps; ++x) {
        const float y = s_col[x][q];
        if (y < v) {
          v = y;
          w = x;
        }
      }
      atomicMin(&bkey[(size_t)b * m + c0 + e],
                nn_split::make_key(v, rb * warps + w));
    }
  }
  if (seg >= 0) post_rows(best, grp, seg, rblk, warps, n, fkey);
}

// One thread per src point (forward) and per tgt point (reverse): the first
// index of the key's group at the key's distance.
__global__ void nn_bidir_decode_kernel(
    const float* __restrict__ src, const float* __restrict__ tgt, int batch,
    int n, int m, int run, const Key* __restrict__ fkey,
    const Key* __restrict__ bkey, float* __restrict__ fd,
    long long* __restrict__ fi, float* __restrict__ bd,
    long long* __restrict__ bi) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nf = (size_t)batch * n;
  const size_t nb = (size_t)batch * m;
  if (t >= nf + nb) return;
  const bool rev = t >= nf;
  const size_t o = rev ? t - nf : t;
  const Key k = (rev ? bkey : fkey)[o];
  const float v = nn_split::key_dist(k);
  const int g = nn_split::key_index(k);
  int idx;
  if (!rev) {  // src point o % n against tgt columns [g L, g L + L)
    const float* q = src + 3 * o;
    const float* t0 = tgt + 3 * (o / n) * m;
    const int lo = g * run, hi = min(m, lo + run);
    idx = lo;
    for (int c = lo; c < hi; ++c) {
      const float* p = t0 + 3 * c;
      if (nn_split::sqdist(q[0], q[1], q[2], p[0], p[1], p[2]) == v) {
        idx = c;
        break;
      }
    }
    fd[o] = v;
    fi[o] = idx;
  } else {  // tgt point o % m against src rows [g RT, g RT + RT)
    const float* p = tgt + 3 * o;
    const float* s0 = src + 3 * (o / m) * n;
    const int lo = g * kRT, hi = min(n, lo + kRT);
    idx = lo;
    for (int r = lo; r < hi; ++r) {
      const float* q = s0 + 3 * r;
      if (nn_split::sqdist(q[0], q[1], q[2], p[0], p[1], p[2]) == v) {
        idx = r;
        break;
      }
    }
    bd[o] = v;
    bi[o] = idx;
  }
}

}  // namespace

// warps a block (1, 2, 4 or 8), run L (columns of a lane a chunk, 1-16)
// and the blocks of the grid as ops/cuda_nn.nn_bidir_plan gives them; fkey
// (B, N) and bkey (B, M): 64-bit scratch that the wrapper allocates.
extern "C" int reart_nn_bidir(const float* src, const float* tgt, int batch,
                              int n, int m, int warps, int run, int blocks,
                              float* fd, long long* fi, float* bd,
                              long long* bi, Key* fkey, Key* bkey,
                              void* stream) {
  if (warps < 1 || warps > kMaxWarps || (warps & (warps - 1)) != 0 ||
      run < 1 || run > kMaxRun || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nf = (size_t)batch * n;
  const size_t nb = (size_t)batch * m;
  cudaError_t err = cudaMemsetAsync(fkey, 0xff, nf * sizeof(Key), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(bkey, 0xff, nb * sizeof(Key), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (m + 32 * run - 1) / (32 * run);  // of a cloud
  const int rblk = (n + warps * kRT - 1) / (warps * kRT);
  const long long units = (long long)batch * rblk * chunks;
  nn_bidir_scan_kernel<<<(unsigned)(blocks < units ? blocks : units),
                         32 * warps, 0, st>>>(src, tgt, n, m, run, chunks,
                                              rblk, units, fkey, bkey);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_bidir_decode_kernel<<<(unsigned)((nf + nb + 255) / 256), 256, 0, st>>>(
      src, tgt, batch, n, m, run, fkey, bkey, fd, fi, bd, bi);
  return static_cast<int>(cudaGetLastError());
}
