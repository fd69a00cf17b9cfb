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
// What bounds it on an H100: float32 ALU throughput, ~10 instructions per
// (query, anchor) pair; 151M pairs at (9, 4096, 4096). Memory traffic is the
// clouds only (under 2 MB).
//
// Design: one query per thread with a running top-3 in registers, inserted
// with strict '<' while the anchors are walked in ascending index (the same
// order as the reference's three masked-argmin passes). Anchors are staged
// through shared memory in tiles of 1024 (16 KB) with |r|^2 precomputed per
// tile, so M has no cap; the 3 winners' flows are read once at the end.
// FAR-padded anchors (1e6) give distances near 3e12 and never enter the
// top-3 while 3 real anchors exist. Built with -fmad=false, so every sum
// rounds as the plain version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 1024;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  float s = x * x + y * y;
  return s + z * z;
}

__global__ void __launch_bounds__(kBlock)
blend3_kernel(const float* __restrict__ query, const float* __restrict__ ref,
              const float* __restrict__ flow, int n, int m,
              float* __restrict__ out, float* __restrict__ min_d,
              float* __restrict__ flow_d) {
  __shared__ float4 s_ref[kTile];  // x, y, z, |r|^2
  const int b = blockIdx.y;
  const float* q = query + (size_t)b * n * 3;
  const float* r = ref + (size_t)b * m * 3;
  const float* f = flow + (size_t)b * m * 3;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool active = i < n;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  const float q2 = sqnorm(qx, qy, qz);
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int j0 = 0, j1 = 0, j2 = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kBlock) {
      const float* p = r + 3 * (size_t)(t0 + k);
      s_ref[k] = make_float4(p[0], p[1], p[2], sqnorm(p[0], p[1], p[2]));
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const float4 p = s_ref[k];
      float cross = qx * p.x + qy * p.y;
      cross = cross + qz * p.z;
      float d = (q2 + p.w) - 2.f * cross;
      d = fmaxf(d, 0.f);
      if (d < d2) {
        const int j = t0 + k;
        if (d < d1) {
          d2 = d1;
          j2 = j1;
          if (d < d0) {
            d1 = d0;
            j1 = j0;
            d0 = d;
            j0 = j;
          } else {
            d1 = d;
            j1 = j;
          }
        } else {
          d2 = d;
          j2 = j;
        }
      }
    }
  }
  if (!active) return;

  const float dist0 = fmaxf(sqrtf(d0), 1e-10f);
  const float dist1 = fmaxf(sqrtf(d1), 1e-10f);
  const float dist2 = fmaxf(sqrtf(d2), 1e-10f);
  const float w0 = 1.f / dist0, w1 = 1.f / dist1, w2 = 1.f / dist2;
  const float wsum = (w0 + w1) + w2;
  const float* f0 = f + 3 * (size_t)j0;
  const float* f1 = f + 3 * (size_t)j1;
  const float* f2 = f + 3 * (size_t)j2;
  const size_t o = (size_t)b * n + i;
  for (int c = 0; c < 3; ++c) {
    float s = w0 * f0[c] + w1 * f1[c];
    s = s + w2 * f2[c];
    out[3 * o + c] = s / wsum;
  }
  min_d[o] = dist0;
  const float fs0 = sqnorm(f0[0], f0[1], f0[2]);
  const float fs1 = sqnorm(f1[0], f1[1], f1[2]);
  const float fs2 = sqnorm(f2[0], f2[1], f2[2]);
  flow_d[o] = fmaxf(fmaxf(fs0, fs1), fs2);
}

}  // namespace

extern "C" int reart_blend3(const float* query, const float* ref,
                            const float* flow, int batch, int n, int m,
                            float* out, float* min_d, float* flow_d,
                            void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock, batch);
  blend3_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      query, ref, flow, n, m, out, min_d, flow_d);
  return static_cast<int>(cudaGetLastError());
}
