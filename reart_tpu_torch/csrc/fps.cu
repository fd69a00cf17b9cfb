// Masked farthest-point sampling, the whole sequential loop in one launch.
//
// Replaces reart_tpu/ops/pallas_fps.py: fps_pallas / _fps_kernel. For xyz
// (B, N, 3) float32 and mask (B, N) bool, writes out (B, npoint) int64: the
// first masked index (0 when nothing is masked), then npoint - 1 times the
// masked point farthest from the selected set. Squared distances are
// (dx^2 + dy^2) + dz^2, running distances are float32 minima, and ties go
// to the lowest index, so the order is bit-identical to the plain loop
// (reart_tpu/ops/sampling.py: _fps_loop).
//
// What bounds it on an H100: latency. The npoint steps are sequential, and
// each is a block-wide argmax over N values (two barriers); the arithmetic
// is ~10 instructions per point per step.
//
// Design: one 1024-thread block per cloud. The cloud and the running
// distances live in shared memory (16 bytes a point, so N <= 14528 within
// the 227 KB a block may use). Masked-out points hold -inf as their running
// distance, which fminf never raises, so they never win. The argmax is a
// warp shuffle reduction then one warp over the 32 warp results, comparing
// (value, index) so equal values keep the lower index. Built with
// -fmad=false so the distance rounds as the plain version's.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const bool* __restrict__ mask,
           int n, int npoint, long long* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sd = sz + n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  xyz += (size_t)b * n * 3;
  mask += (size_t)b * n;
  out += (size_t)b * npoint;

  if (tid == 0) s_far = INT_MAX;
  __syncthreads();
  int first = INT_MAX;
  for (int k = tid; k < n; k += kThreads) {
    sx[k] = xyz[3 * k];
    sy[k] = xyz[3 * k + 1];
    sz[k] = xyz[3 * k + 2];
    const bool in = mask[k];
    sd[k] = in ? INFINITY : -INFINITY;
    if (in && k < first) first = k;
  }
  if (first != INT_MAX) atomicMin(&s_far, first);
  __syncthreads();
  if (tid == 0 && s_far == INT_MAX) s_far = 0;
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    const int far = s_far;
    if (tid == 0) out[it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int k = tid; k < n; k += kThreads) {
      const float dx = sx[k] - cx;
      const float dy = sy[k] - cy;
      const float dz = sz[k] - cz;
      float d = dx * dx + dy * dy;
      d = d + dz * dz;
      const float nd = fminf(sd[k], d);
      sd[k] = nd;
      // k rises within a thread: '>' keeps the first maximum; the
      // bi == INT_MAX term lets an all -inf row still name its lowest index
      if (nd > bv || bi == INT_MAX) {
        bv = nd;
        bi = k;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) s_far = bi;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int reart_fps(const float* xyz, const bool* mask, int batch, int n,
                         int npoint, long long* out, void* stream) {
  const size_t smem = 16 * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, mask, n, npoint, out);
  return static_cast<int>(cudaGetLastError());
}
