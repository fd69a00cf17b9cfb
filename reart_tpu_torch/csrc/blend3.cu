// Fused 3-NN inverse-distance flow blend.
//
// Replaces reart_tpu/ops/pallas_nn.py: blend3_pallas / _blend3_kernel. For
// query (B, N, 3) and anchors ref/flow (B, M, 3), float32, M >= 3:
//   out    (B, N, 3): sum_j w_j flow[k_j] / sum_j w_j over the 3 nearest
//                     anchors k_0..k_2, w_j = 1 / max(sqrt(d_j), 1e-10);
//   min_d  (B, N):    max(sqrt(d_0), 1e-10), the nearest anchor distance;
//   flow_d (B, N):    the largest squared flow norm of the 3 anchors.
// Distances are ||q||^2 + ||r||^2 - 2 q.r clamped at 0, as in the Pallas
// kernel; ties go to the lowest anchor index.
//
// What bounds it on an H100: float32 issue rate (nn_split.cuh): 151M
// (query, anchor) pairs at (9, 4096, 4096), each a 9-instruction distance,
// and the exact top-3 with indices costs about 13 compare-and-select
// instructions a pair if every pair pays for it.
//
// Design (nn_split.cuh): a block of 128 threads holds 256 / S queries and
// cuts the M anchors into S contiguous slices, one per group of 128 / S
// threads; the wrapper picks S (1..16) so that the grid has several blocks
// per SM. Each thread carries 2 queries, so one 16-byte shared-memory load
// of an anchor (x, y, z, |r|^2) feeds 2 pairs. Two passes over the slice:
//   1. threshold: the 3 smallest distances (values only: a min/max network,
//      no index, no branch) over every 4th anchor; their union over the S
//      slices gives T >= the query's third-nearest distance;
//   2. main: the running top-3 with strict '<' in ascending index, taking
//      only distances <= T. Each of the query's 3 nearest is <= T, so it
//      still lands in its slice's list, while a pair that passes is rare:
//      the fast path is the distance and one compare, and a warp takes the
//      insert only when one of its lanes needs it (a warp-uniform branch).
// The S partial lists of a query are then merged through shared memory in
// slice order, which is (distance, index) order, and one thread per query
// runs the epilogue: roots, weights, the three winners' flows (read once),
// flow_d. Anchors are staged 1024 at a time (1024 / S per slice, each
// slice's run padded by one float4 against bank conflicts), so M has no
// cap. FAR-padded anchors (1e6) give distances near 3e12 and never enter
// the top-3 while 3 real anchors exist. Built with -fmad=false, so every
// sum rounds as the plain version's.

#include <cuda_runtime.h>
#include <math.h>

#include "nn_split.cuh"

namespace {

using nn_split::sqnorm;
using nn_split::Top3;

constexpr int kThreads = 128;
constexpr int kQ = 2;        // queries per thread
constexpr int kTile = 1024;  // anchors staged per step, all slices together
constexpr int kSample = 4;   // the threshold pass reads every 4th anchor

template <int S>
__global__ void __launch_bounds__(kThreads)
blend3_kernel(const float* __restrict__ query, const float* __restrict__ ref,
              const float* __restrict__ flow, int n, int m,
              float* __restrict__ out, float* __restrict__ min_d,
              float* __restrict__ flow_d) {
  constexpr int G = kThreads / S;  // threads (query groups) of one slice
  constexpr int QB = G * kQ;       // queries per block
  constexpr int C = kTile / S;     // positions of one slice per step
  constexpr int kRun = C + 1;      // a slice's run in shared memory
  __shared__ float4 s_ref[S * kRun];
  __shared__ float s_d[S * QB * 3];  // the partial lists
  __shared__ int s_j[S * QB * 3];
  __shared__ float s_thr[QB];

  const int b = blockIdx.y;
  const float* q = query + (size_t)b * n * 3;
  const float* r = ref + (size_t)b * m * 3;
  const float* f = flow + (size_t)b * m * 3;
  const int s = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int q0 = blockIdx.x * QB;
  const int len = (m + S - 1) / S;  // slice s holds [s * len, (s + 1) * len)
  const int lo = s * len;

  // Stage positions [t0, t0 + C) of every slice's walk, position t of
  // slice ss being anchor ss * len + t * stride. Positions past the slice
  // hold NaN, which never passes a '<' and which fminf passes over, so every
  // lane walks every position and the warp votes stay convergent.
  auto stage = [&](int t0, int stride) {
    __syncthreads();
    for (int e = threadIdx.x; e < S * C; e += kThreads) {
      const int ss = e / C;
      const int c = e % C;
      const int t = (t0 + c) * stride;
      const int a = ss * len + t;
      float4 v = make_float4(NAN, NAN, NAN, NAN);
      if (t < len && a < m) {
        const float* p = r + 3 * (size_t)a;
        v = make_float4(p[0], p[1], p[2], sqnorm(p[0], p[1], p[2]));
      }
      s_ref[ss * kRun + c] = v;
    }
    __syncthreads();
  };

  float qx[kQ], qy[kQ], qz[kQ], q2[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + k * G + g;
    qx[k] = qy[k] = qz[k] = 0.f;
    if (i < n) {
      qx[k] = q[3 * i];
      qy[k] = q[3 * i + 1];
      qz[k] = q[3 * i + 2];
    }
    q2[k] = sqnorm(qx[k], qy[k], qz[k]);
  }
  // the distance before its clamp at 0
  auto raw = [&](int k, const float4& p) {
    float cross = qx[k] * p.x + qy[k] * p.y;
    cross = cross + qz[k] * p.z;
    return (q2[k] + p.w) - 2.f * cross;
  };

  // Threshold pass: the 3 smallest distances (values only, a min/max
  // network) over every kSample-th anchor of the slice; their union over
  // the slices bounds the query's third-nearest distance from above: T.
  float v[kQ][3];
#pragma unroll
  for (int k = 0; k < kQ; ++k) v[k][0] = v[k][1] = v[k][2] = INFINITY;
  const int sub = (len + kSample - 1) / kSample;
  for (int t0 = 0; t0 < sub; t0 += C) {
    stage(t0, kSample);
    const float4* tile = s_ref + s * kRun;
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      const float4 p = tile[c];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float d = raw(k, p);
        const float m2 = fminf(d, v[k][2]);
        const float m1 = fminf(d, v[k][1]);
        v[k][2] = fmaxf(v[k][1], m2);
        v[k][1] = fmaxf(v[k][0], m1);
        v[k][0] = fminf(d, v[k][0]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int o = (s * QB + k * G + g) * 3;
#pragma unroll
    for (int w = 0; w < 3; ++w) s_d[o + w] = fmaxf(v[k][w], 0.f);
  }
  __syncthreads();
  for (int lq = threadIdx.x; lq < QB; lq += kThreads) {
    float a0 = INFINITY, a1 = INFINITY, a2 = INFINITY;
    for (int ss = 0; ss < S; ++ss) {
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const float x = s_d[(ss * QB + lq) * 3 + w];
        const float m2 = fminf(x, a2);
        const float m1 = fminf(x, a1);
        a2 = fmaxf(a1, m2);
        a1 = fmaxf(a0, m1);
        a0 = fminf(x, a0);
      }
    }
    s_thr[lq] = a2;
  }
  __syncthreads();

  // Main pass: a running top-3 over the slice, strict '<' in ascending
  // index, that takes only distances <= T: every one of the query's 3
  // nearest is <= T, so each still lands in its slice's list, and the
  // rare lane that needs an insert is taken by a warp-uniform branch.
  float u[kQ];  // d < u[k]: d <= T and d below the list's third
  Top3 top[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    u[k] = nextafterf(s_thr[k * G + g], INFINITY);
    top[k].clear();
  }
  for (int t0 = 0; t0 < len; t0 += C) {
    stage(t0, 1);
    const float4* tile = s_ref + s * kRun;
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      const float4 p = tile[c];
      const int a = lo + t0 + c;
      // a negative distance clamps to 0 <= T: it passes, as it should
      float d[kQ];
      bool want = false;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        d[k] = raw(k, p);
        want |= d[k] < u[k];
      }
      if (__any_sync(0xffffffffu, want)) {
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          if (d[k] < u[k]) {
            top[k].insert(fmaxf(d[k], 0.f), a);
            u[k] = fminf(u[k], top[k].d[2]);
          }
        }
      }
    }
  }

  // the partial lists, slice-major: query lq's list of slice s at
  // (s * QB + lq) * 3
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int o = (s * QB + k * G + g) * 3;
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      s_d[o + w] = top[k].d[w];
      s_j[o + w] = top[k].j[w];
    }
  }
  __syncthreads();

  for (int lq = threadIdx.x; lq < QB; lq += kThreads) {
    const int i = q0 + lq;
    if (i >= n) break;
    Top3 best;
    best.clear();
    for (int ss = 0; ss < S; ++ss) {  // ascending slices: ascending index
      const int o = (ss * QB + lq) * 3;
#pragma unroll
      for (int w = 0; w < 3; ++w) best.insert(s_d[o + w], s_j[o + w]);
    }
    const float dist0 = fmaxf(sqrtf(best.d[0]), 1e-10f);
    const float dist1 = fmaxf(sqrtf(best.d[1]), 1e-10f);
    const float dist2 = fmaxf(sqrtf(best.d[2]), 1e-10f);
    const float w0 = 1.f / dist0, w1 = 1.f / dist1, w2 = 1.f / dist2;
    const float wsum = (w0 + w1) + w2;
    const float* f0 = f + 3 * (size_t)best.j[0];
    const float* f1 = f + 3 * (size_t)best.j[1];
    const float* f2 = f + 3 * (size_t)best.j[2];
    const size_t o = (size_t)b * n + i;
    for (int c = 0; c < 3; ++c) {
      float sum = w0 * f0[c] + w1 * f1[c];
      sum = sum + w2 * f2[c];
      out[3 * o + c] = sum / wsum;
    }
    min_d[o] = dist0;
    const float fs0 = sqnorm(f0[0], f0[1], f0[2]);
    const float fs1 = sqnorm(f1[0], f1[1], f1[2]);
    const float fs2 = sqnorm(f2[0], f2[1], f2[2]);
    flow_d[o] = fmaxf(fmaxf(fs0, fs1), fs2);
  }
}

template <int S>
void launch(const float* query, const float* ref, const float* flow,
            int batch, int n, int m, float* out, float* min_d, float* flow_d,
            cudaStream_t stream) {
  constexpr int QB = (kThreads / S) * kQ;
  const dim3 grid((n + QB - 1) / QB, batch);
  blend3_kernel<S><<<grid, kThreads, 0, stream>>>(query, ref, flow, n, m,
                                                  out, min_d, flow_d);
}

}  // namespace

// One kernel launch per call. `slices` is S, a power of two in [1, 16].
extern "C" int reart_blend3(const float* query, const float* ref,
                            const float* flow, int batch, int n, int m,
                            int slices, float* out, float* min_d,
                            float* flow_d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slices) {
    case 1: launch<1>(query, ref, flow, batch, n, m, out, min_d, flow_d, st);
      break;
    case 2: launch<2>(query, ref, flow, batch, n, m, out, min_d, flow_d, st);
      break;
    case 4: launch<4>(query, ref, flow, batch, n, m, out, min_d, flow_d, st);
      break;
    case 8: launch<8>(query, ref, flow, batch, n, m, out, min_d, flow_d, st);
      break;
    case 16:
      launch<16>(query, ref, flow, batch, n, m, out, min_d, flow_d, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
