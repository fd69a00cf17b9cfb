// Ball query: for every centroid the first `nsample` points of its cloud that
// lie within `radius`, in point order.
//
// Replaces reart_tpu/ops/pallas_nn.py: ball_query_pallas / _bq_kernel (and
// the sort formulation of reart_tpu/ops/sampling.py: ball_query). For xyz
// (B, N, 3) and centroids new_xyz (B, S, 3), float32, writes out
// (B, S, nsample) int64: the indices j with
//   (dx^2 + dy^2) + dz^2 < r2        (strict, float32, no FMA)
// ascending in j, the first nsample of them; slots past the last hit hold the
// first hit; a centroid without a hit holds 0 in every slot. r2 is rounded to
// float32 by the caller, so the kernel and the plain version compare against
// the same number.
//
// What bounds it on an H100: float32 ALU throughput. Every (centroid, point)
// pair that is looked at costs 8 flops and a compare; the clouds and the
// output are a few MB. How many pairs are looked at depends on the data: a
// centroid stops at its nsample-th hit. In practice the time is set by a
// chain of dependent steps per centroid (load, distance, rank, the next
// step), not by either bound: SA1 at r=0.2, K=128 looks at ~3000 points a
// centroid.
//
// Design: one warp per centroid, W centroids a block (the wrapper picks W,
// ball_query_warps, so that the grid fills the card).
//   * The block copies the whole cloud into shared memory once (packed xyz,
//     48 KB for 4096 points; up to kWholeMax points), in 16-byte cp.async
//     chunks lined up with the source, then one barrier. Past kWholeMax the
//     cloud goes through in tiles of kTilePts points with a barrier pair a
//     tile, the block leaving as soon as all its warps are done.
//   * A step of the warp looks at 32 * V points (V = REART_BQ_V): lane l
//     tests points base + 32 v + l for v < V, so its V distances are
//     independent. Then V ballots rank the hits in point order, with one
//     branch a step (skipped by a step without a hit): a hit's slot is the
//     hits before it (the count so far plus the earlier ballots'
//     popcounts) plus the popcount of the lower lanes' bits of its own
//     ballot, and it is written straight to its slot. The
//     warp stops at the step that reaches its nsample-th hit. The dependent
//     chain is ~N / (32 V) steps long instead of N / 32.
//   * The cloud in shared memory is padded to a whole step with +inf
//     points, whose distance never passes the '<'.
// The batch and the centroid blocks are folded into blockIdx.x.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "nn_split.cuh"

#ifndef REART_BQ_V
#error "REART_BQ_V (points a lane looks at per step): see ops/_build.py"
#endif

namespace {

constexpr int kV = REART_BQ_V;
constexpr int kStep = 32 * kV;       // points a warp looks at per step
constexpr int kWholeMax = 16384;     // clouds held whole in shared memory
constexpr int kTilePts = 4096;       // the tile of a larger cloud
constexpr int kMaxWarps = 16;        // centroids a block, at most
constexpr unsigned kFull = 0xffffffffu;

static_assert(kV >= 1 && kV <= 16, "REART_BQ_V in [1, 16]");

// floats of shared memory for a tile of `tile` points: padded to a whole
// step, plus up to 3 floats that line the copy up with the source
__host__ __device__ constexpr int smem_floats(int tile) {
  return 3 * ((tile + kStep - 1) / kStep * kStep) + 4;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int n, int s, int sblk,
                  int tile, float r2, int nsample,
                  long long* __restrict__ out) {
  extern __shared__ __align__(16) float s_raw[];
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x / sblk;
  const int lane = threadIdx.x & 31;
  const int c = (blockIdx.x % sblk) * warps + (threadIdx.x >> 5);
  const bool live = c < s;
  const unsigned lower = (1u << lane) - 1u;
  const float* cloud = xyz + (size_t)b * n * 3;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  long long* o = out;
  if (live) {
    const float* p = new_xyz + ((size_t)b * s + c) * 3;
    cx = p[0];
    cy = p[1];
    cz = p[2];
    o = out + ((size_t)b * s + c) * nsample;
  }
  int count = 0;   // hits so far (warp-uniform)
  int first = 0;   // the first hit (warp-uniform), 0 while there is none
  bool done = !live;

  for (int t0 = 0; t0 < n; t0 += tile) {
    // a later tile: every warp is past the previous one (or all are done)
    if (t0 > 0 && __syncthreads_and(done)) break;
    const int cnt = min(tile, n - t0);
    const float* src = cloud + 3 * (size_t)t0;
    // pts[i] and src[i] share their offset within 16 bytes
    const int mis =
        static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* pts = s_raw + mis;
    const int nf = 3 * cnt;
    const int head = min(nf, (4 - mis) & 3);
    const int chunks = (nf - head) / 4;
    for (int e = threadIdx.x; e < chunks; e += blockDim.x)
      cp_async::copy16(pts + head + 4 * e, src + head + 4 * e);
    for (int e = threadIdx.x; e < head; e += blockDim.x)
      cp_async::copy4(pts + e, src + e);
    for (int e = head + 4 * chunks + threadIdx.x; e < nf; e += blockDim.x)
      cp_async::copy4(pts + e, src + e);
    const int padded = 3 * ((cnt + kStep - 1) / kStep * kStep);
    for (int e = nf + threadIdx.x; e < padded; e += blockDim.x)
      pts[e] = INFINITY;
    cp_async::wait_all();
    __syncthreads();

    if (!done) {
      const float* pl = pts + 3 * lane;  // this lane's first point
      for (int k0 = 0; k0 < cnt; k0 += kStep, pl += 3 * kStep) {
        bool hit[kV];
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const float* p = pl + 96 * v;
          hit[v] = nn_split::sqdist(cx, cy, cz, p[0], p[1], p[2]) < r2;
        }
        unsigned bal[kV], any = 0;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          bal[v] = __ballot_sync(kFull, hit[v]);
          any |= bal[v];
        }
        if (any) {  // warp-uniform: a step without a hit costs no more
          if (count == 0) {  // the first hit, once
#pragma unroll
            for (int v = kV - 1; v >= 0; --v)
              if (bal[v]) first = t0 + k0 + 32 * v + __ffs(bal[v]) - 1;
          }
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const int slot = count + __popc(bal[v] & lower);
            if (hit[v] && slot < nsample) o[slot] = t0 + k0 + 32 * v + lane;
            count += __popc(bal[v]);
          }
        }
        if (count >= nsample) {
          done = true;
          break;
        }
      }
    }
  }
  if (live) {
    for (int k = min(count, nsample) + lane; k < nsample; k += 32)
      o[k] = first;
  }
}

}  // namespace

// One kernel launch per call; `warps` centroids a block, in [1, 16].
extern "C" int reart_ball_query(const float* xyz, const float* new_xyz,
                                int batch, int n, int s, float r2,
                                int nsample, int warps, long long* out,
                                void* stream) {
  if (warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = n <= kWholeMax ? n : kTilePts;
  const size_t smem = sizeof(float) * smem_floats(tile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sblk = (s + warps - 1) / warps;
  ball_query_kernel<<<(unsigned)batch * sblk, warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, n, s, sblk, tile, r2, nsample, out);
  return static_cast<int>(cudaGetLastError());
}
