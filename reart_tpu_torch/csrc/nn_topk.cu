// Batched k nearest neighbours: the k smallest squared distances of every
// query to a reference cloud, ascending, with their indices.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn_topk_pallas / _nn_kernel. For
// query (B, N, 3) and ref (B, M, 3), float32:
//   out_d (B, N, k): squared distances (dx^2 + dy^2) + dz^2, ascending;
//   out_i (B, N, k): int64 indices into the reference cloud.
// Equal distances keep ascending index order. With M < k the missing slots
// hold (+inf, 0). A reference shared by R consecutive query clouds is
// passed folded: B / R clouds of R * N queries each (ops/cuda_nn.py), so
// the clouds that share a reference share its staged tiles as well.
//
// What bounds it on an H100: float32 instruction rate. Every (query, ref)
// pair is 8 float operations (3 differences, 3 squares, 2 sums;
// -fmad=false, so no FMA), and the clouds and outputs are a few MB. At the
// seg-refinement table shape, (180, 4096) queries against 9 clouds of
// 4096, that is 3.0 G pairs; with the running minimum about 9 instructions
// a pair, 0.81 ms of instructions on 132 SMs at 1.98 GHz. At the other
// shapes the paths launch (IK's ~6 queries, the backbone's 3-NN of
// 128-4096 queries) the grid, not the instruction rate, sets the time: a
// block per 128 queries leaves most SMs idle.
//
// Design (one launch; the wrapper picks Q and S, nn_topk_plan):
//   * A block of 128 threads holds 128 * Q / S queries and cuts the
//     reference axis into S contiguous slices (S a power of two, 1-16), one
//     per group of 128 / S threads. With few queries, S > 1 fills the card;
//     with many, S = 1 and each thread carries Q = REART_NN_QPT queries, so
//     one shared-memory load of a reference point serves Q pairs.
//   * The reference goes through shared memory in steps of 1024 points
//     (1024 / S a slice), packed xyz as in device memory, read back as three
//     16-byte loads per 4 points. Two buffers: the next step's copy
//     (cp.async, 16 bytes where aligned) is in flight while the current step
//     is scanned; one barrier a step.
//   * k = 1, branch-free: a slice is walked in subtiles of 32 points; per
//     query a subtile's minimum is one fminf a pair, and the running best
//     (value, subtile) is replaced only by a strictly smaller subtile
//     minimum. So the best value is exact and the subtile recorded is the
//     first that holds it; the index is found after the scan by one warp
//     ballot over that subtile's 32 distances (the first equal one).
//   * k > 1: a sorted running top-k per query in registers, strict '<' in
//     ascending index; the common pair is the distance and one compare with
//     the k-th slot. (A warp vote before the insert was slower: with 32
//     lanes of random queries some lane nearly always needs the insert.)
//   * Merge: each slice's (distance, index) list goes to
//     shared memory as 64-bit keys (float bits << 32 | index; distances are
//     never negative, so keys order as (distance, index)), one query of each
//     thread a round. The S slices of a query are then S neighbouring
//     lanes, which take the k smallest keys over the S lists, one shuffle
//     reduction a slot. That equals one strict '<' walk over the whole
//     reference: ties go to the lowest index whatever the slicing, so S
//     changes no bit.
// Ragged sizes are masked (positions past a slice or past M are staged as
// +inf points, whose distance never passes a '<'), not padded in memory.
// Built with -fmad=false so every sum rounds as the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "nn_split.cuh"

#ifndef REART_NN_QPT
#error "REART_NN_QPT (queries per thread): see ops/_build.py"
#endif

namespace {

using nn_split::Key;

constexpr int kThreads = 128;
constexpr int kTile = 1024;      // reference points staged per step
constexpr int kMaxSlices = 16;
constexpr int kSub = 32;         // k = 1: points per subtile; slices are
                                 // multiples of it
constexpr int kRunPad = 4;       // floats after each slice's run: the runs
                                 // of one step start 4 banks apart
constexpr int kStage = 3 * kTile + kRunPad * kMaxSlices;  // floats a buffer
constexpr int kQpt = REART_NN_QPT;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kQpt >= 1 && kQpt <= 8, "REART_NN_QPT in [1, 8]");

__host__ __device__ constexpr int max_int(int a, int b) {
  return a > b ? a : b;
}

// The smallest key over each aligned group of `width` lanes (a power of two
// up to 32), in every lane of the group.
__device__ __forceinline__ Key group_min(Key k, int width) {
  for (int off = 1; off < width; off <<= 1)
    k = nn_split::key_min(k, __shfl_xor_sync(kFull, k, off));
  return k;
}

// K sorted (d, j) slots; strict '<' keeps the earlier of equal distances
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&j)[K], float x,
                                       int k) {
  d[K - 1] = x;
  j[K - 1] = k;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (d[s] < d[s - 1]) {
      const float td = d[s];
      d[s] = d[s - 1];
      d[s - 1] = td;
      const int tj = j[s];
      j[s] = j[s - 1];
      j[s - 1] = tj;
    }
  }
}

template <int K, int Q>
__global__ void __launch_bounds__(kThreads)
nn_topk_kernel(const float* __restrict__ query, const float* __restrict__ ref,
               int n, int m, int slices, int len, int run, int nblk,
               int k_out, float* __restrict__ out_d,
               long long* __restrict__ out_i) {
  // the two staging buffers; after the scan, the merge keys of one round
  __shared__ __align__(16) float smem[max_int(2 * kStage, 2 * kThreads * K)];

  const int S = slices;
  const int G = kThreads / S;     // threads (query groups) of one slice
  const int QB = G * Q;           // queries of the block
  const int b = blockIdx.x / nblk;
  const int q0 = (blockIdx.x % nblk) * QB;
  const int s = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int lo = s * len;         // slice s: points [lo, lo + len)
  const float* q = query + (size_t)b * n * 3;
  const float* r = ref + (size_t)b * m * 3;
  const int stride = 3 * run + kRunPad;  // floats of one slice's run
  const bool aligned = (reinterpret_cast<uintptr_t>(r) & 15) == 0;

  // query i of this thread is block query g + G * i; an idle one is NaN,
  // whose distances never pass a '<' and which fminf passes over
  float qx[Q], qy[Q], qz[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int qi = q0 + g + G * i;
    qx[i] = qy[i] = qz[i] = NAN;
    if (qi < n) {
      qx[i] = q[3 * (size_t)qi];
      qy[i] = q[3 * (size_t)qi + 1];
      qz[i] = q[3 * (size_t)qi + 2];
    }
  }

  // Copy positions [t0, t0 + run) of this thread's slice into `buf`: the
  // slice's group of G threads copies its own run, 4 floats at a time.
  // Positions past the slice or past M become +inf points.
  auto stage = [&](int t0, float* buf) {
    float* dst = buf + s * stride;
    const int a0 = lo + t0;
    const int lim = 3 * min(run, min(len - t0, m - a0));  // valid floats
    const float* src = r + 3 * (size_t)a0;
    for (int w = 4 * g; w < 3 * run; w += 4 * G) {
      if (aligned && w + 4 <= lim) {
        cp_async::copy16(dst + w, src + w);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (w + u < lim)
            cp_async::copy4(dst + w + u, src + w + u);
          else
            dst[w + u] = INFINITY;
        }
      }
    }
    cp_async::commit();
  };

  float bd[Q][K];
  int bj[Q][K];  // k = 1: the first point of the subtile holding bd
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      bd[i][t] = INFINITY;
      bj[i][t] = K == 1 ? lo : 0;
    }
  }

  const int steps = (len + run - 1) / run;
  stage(0, smem);
  for (int step = 0; step < steps; ++step) {
    const int t0 = step * run;
    float* buf = smem + (step & 1) * kStage;
    // this step's copies have landed and are visible; every thread is
    // past the previous step, so its buffer may be refilled
    cp_async::wait_all();
    __syncthreads();
    if (step + 1 < steps) stage(t0 + run, smem + ((step + 1) & 1) * kStage);
    const float4* run4 = reinterpret_cast<const float4*>(buf + s * stride);

    for (int c0 = 0; c0 < run && t0 + c0 < len; c0 += kSub) {
      float tm[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) tm[i] = INFINITY;
#pragma unroll 2
      for (int u = 0; u < kSub / 4; ++u) {
        // 4 points in 12 floats: (x0 y0 z0 x1) (y1 z1 x2 y2) (z2 x3 y3 z3)
        const int e = 3 * (c0 / 4 + u);
        const float4 v0 = run4[e], v1 = run4[e + 1], v2 = run4[e + 2];
        const float px[4] = {v0.x, v0.w, v1.z, v2.y};
        const float py[4] = {v0.y, v1.x, v1.w, v2.z};
        const float pz[4] = {v0.z, v1.y, v2.x, v2.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float d[Q];
#pragma unroll
          for (int i = 0; i < Q; ++i)
            d[i] = nn_split::sqdist(qx[i], qy[i], qz[i], px[p], py[p], pz[p]);
          if (K == 1) {
#pragma unroll
            for (int i = 0; i < Q; ++i) tm[i] = fminf(tm[i], d[i]);
          } else {
            const int j = lo + t0 + c0 + 4 * u + p;
#pragma unroll
            for (int i = 0; i < Q; ++i)
              if (d[i] < bd[i][K - 1]) insert<K>(bd[i], bj[i], d[i], j);
          }
        }
      }
      if (K == 1) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          if (tm[i] < bd[i][0]) {
            bd[i][0] = tm[i];
            bj[i][0] = lo + t0 + c0;
          }
        }
      }
    }
  }
  const size_t ob = (size_t)b * n;

  // The merge, one round a query of the thread: round i takes the block's
  // queries g + G * i. Thread (mg, ms) holds slice ms's list of query mg:
  // the S threads of a query are S neighbouring lanes, which reduce by
  // shuffles (S <= 16 divides 32).
  Key* keys = reinterpret_cast<Key*>(smem);  // [slice][g][slot]
  const int mg = threadIdx.x / S;
  const int ms = threadIdx.x % S;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    __syncthreads();  // the buffers, or the last round's keys, are free
#pragma unroll
    for (int t = 0; t < K; ++t)
      keys[(s * G + g) * K + t] = nn_split::make_key(bd[i][t], bj[i][t]);
    __syncthreads();
    const int qi = q0 + mg + G * i;
    const bool live = qi < n;
    const size_t o = (ob + qi) * k_out;
    if (K == 1) {
      const Key key = group_min(keys[ms * G + mg], S);
      const float best = nn_split::key_dist(key);
      const int j0 = nn_split::key_index(key);
      // the first point of subtile j0 at distance `best`: the subtile is
      // the first that holds it, so no earlier point does
      int first = kSub;
      if (live) {
        const float x = q[3 * (size_t)qi], y = q[3 * (size_t)qi + 1],
                    z = q[3 * (size_t)qi + 2];
        for (int c = ms; c < kSub && j0 + c < m; c += S) {
          const float* p = r + 3 * (size_t)(j0 + c);
          if (nn_split::sqdist(x, y, z, p[0], p[1], p[2]) == best) {
            first = c;
            break;
          }
        }
      }
      first = static_cast<int>(group_min(static_cast<Key>(first), S));
      if (live && ms == 0) {
        out_d[o] = best;
        out_i[o] = j0 + first;
      }
    } else {
      int next = 0;  // the head of this thread's slice list
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const Key key =
            next < K ? keys[(ms * G + mg) * K + next] : ~0ull;
        const Key win = group_min(key, S);
        if (key == win) ++next;
        if (live && ms == 0 && t < k_out) {
          out_d[o + t] = nn_split::key_dist(win);
          out_i[o + t] = nn_split::key_index(win);
        }
      }
    }
  }
}

template <int K, int Q>
int launch(const float* query, const float* ref, int batch, int n, int m,
           int slices, int k_out, float* out_d, long long* out_i,
           cudaStream_t stream) {
  const int qb = kThreads / slices * Q;
  const int nblk = (n + qb - 1) / qb;
  int len = (m + slices - 1) / slices;
  len = (len + kSub - 1) / kSub * kSub;
  const int run = min(kTile / slices, len);
  nn_topk_kernel<K, Q><<<(unsigned)batch * nblk, kThreads, 0, stream>>>(
      query, ref, n, m, slices, len, run, nblk, k_out, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_k(const float* query, const float* ref, int batch, int n, int m,
             int slices, int k_out, float* out_d, long long* out_i,
             cudaStream_t s) {
  if (k_out == 1)
    return launch<1, Q>(query, ref, batch, n, m, slices, k_out, out_d, out_i,
                        s);
  if (k_out <= 3)
    return launch<3, Q>(query, ref, batch, n, m, slices, k_out, out_d, out_i,
                        s);
  return launch<8, Q>(query, ref, batch, n, m, slices, k_out, out_d, out_i,
                      s);
}

}  // namespace

// One kernel launch per call. k_out <= 8: the kernel instance is the
// smallest of K = 1, 3, 8 (the values the package uses) that holds k_out,
// and writes the first k_out of its K slots. qpt is 1, 2 or REART_NN_QPT;
// slices a power of two in [1, 16].
extern "C" int reart_nn_topk(const float* query, const float* ref, int batch,
                             int n, int m, int k_out, int qpt, int slices,
                             float* out_d, long long* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_out < 1 || k_out > 8 || slices < 1 || slices > kMaxSlices ||
      (slices & (slices - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (qpt == 1)
    return launch_k<1>(query, ref, batch, n, m, slices, k_out, out_d, out_i,
                       s);
  if (qpt == 2)
    return launch_k<2>(query, ref, batch, n, m, slices, k_out, out_d, out_i,
                       s);
  if (qpt == kQpt)
    return launch_k<kQpt>(query, ref, batch, n, m, slices, k_out, out_d,
                          out_i, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
