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
// What bounds it on an H100: latency. The npoint picks are sequential, and
// each is a block-wide argmax over N values; the arithmetic is ~12
// instructions per point per pick (8 for the distance, a minimum, a
// compare and two selects), which one SM issues for N = 4096 in ~400
// cycles, and the argmax across warps adds a barrier and two warp
// reductions. The operations bound of the whole card is out of reach.
//
// Design: one block per cloud (256 threads up to 2048 points, 512 past).
// Each thread keeps its points (k = tid + i * threads, ascending in i) and
// their running distances in registers, a fixed count per thread chosen by
// template, so a pick reads no shared memory but the winner's coordinates
// (one broadcast load from a copy of the cloud in shared memory). Past the
// registers' capacity (N > 8192) the coordinates come from that copy and
// only the distances stay in registers. A cluster of blocks a cloud was
// slower on the card: a cluster barrier costs many block barriers.
// Masked-out points and the padding past N hold -inf, which fminf never
// raises; as keys they map below every real distance (>= +0), so they never
// win. The argmax is exact in two redux.sync steps a warp: the largest key
// (__reduce_max_sync), then the lowest index among the lanes that hold it
// (__reduce_min_sync), whatever the layout of points over lanes. Each warp
// writes its (key, index) to a slot of a double-buffered array, and after
// the pick's only __syncthreads every warp reduces the slots itself, so no
// second barrier broadcasts the winner. Built with -fmad=false so the
// distance rounds as the plain version's.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// a block's shared memory (227 KB) less the slots: 16 bytes a point
constexpr int kMaxPoints = 14336;

// A running distance as a key that orders like it: -inf (masked, padding)
// maps to 0, a real distance d >= +0 (a sum of squares, never -0) to its
// bits + 1.
__device__ __forceinline__ unsigned dist_key(float d) {
  return d >= 0.f ? __float_as_uint(d) + 1u : 0u;
}

// The warp's largest key, and the lowest index among the lanes holding it.
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : UINT_MAX);
  key = top;
}

// The block's best (key, index): every thread returns the index. One
// barrier; `slot` must not be written again before every warp has passed
// the next call's barrier (the caller alternates two slot arrays).
template <int kWarps>
__device__ __forceinline__ unsigned block_best(uint2* slot, unsigned key,
                                               unsigned idx, int lane,
                                               int warp) {
  warp_best(key, idx);
  if (lane == 0) slot[warp] = make_uint2(key, idx);
  __syncthreads();
  const uint2 s = lane < kWarps ? slot[lane] : make_uint2(0u, UINT_MAX);
  key = s.x;
  idx = s.y;
  warp_best(key, idx);
  return idx;
}

template <int kThreads, int kPer, bool kRegs>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const bool* __restrict__ mask,
           int n, int npoint, long long* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 s_pt[];  // (N,) x, y, z
  __shared__ uint2 s_slot[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  xyz += (size_t)blockIdx.x * n * 3;
  mask += (size_t)blockIdx.x * n;
  out += (size_t)blockIdx.x * npoint;

  float px[kRegs ? kPer : 1], py[kRegs ? kPer : 1], pz[kRegs ? kPer : 1];
  float pd[kPer];
  unsigned first = UINT_MAX;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = tid + i * kThreads;
    float x = 0.f, y = 0.f, z = 0.f;
    bool in = false;
    if (k < n) {
      x = xyz[3 * k];
      y = xyz[3 * k + 1];
      z = xyz[3 * k + 2];
      in = mask[k];
      s_pt[k] = make_float4(x, y, z, 0.f);
    }
    if (kRegs) {
      px[i] = x;
      py[i] = y;
      pz[i] = z;
    }
    pd[i] = in ? INFINITY : -INFINITY;
    if (in && first == UINT_MAX) first = k;
  }
  // the first masked index, 0 when nothing is masked
  unsigned far = block_best<kWarps>(s_slot[1], first != UINT_MAX, first,
                                    lane, warp);
  if (far == UINT_MAX) far = 0;

  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) out[it] = far;
    const float4 c = s_pt[far];
    float bv = -INFINITY;
    unsigned bi = tid;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = tid + i * kThreads;
      float x, y, z;
      if (kRegs) {
        x = px[i];
        y = py[i];
        z = pz[i];
      } else {
        const float4 p = s_pt[k < n ? k : far];
        x = p.x;
        y = p.y;
        z = p.z;
      }
      const float dx = x - c.x;
      const float dy = y - c.y;
      const float dz = z - c.z;
      float d = dx * dx + dy * dy;
      d = d + dz * dz;
      const float nd = fminf(pd[i], d);
      pd[i] = nd;
      // k rises with i: '>' keeps a thread's first maximum
      if (nd > bv) {
        bv = nd;
        bi = k;
      }
    }
    far = block_best<kWarps>(s_slot[it & 1], dist_key(bv), bi, lane, warp);
  }
}

template <int kThreads, int kPer, bool kRegs>
cudaError_t launch(const float* xyz, const bool* mask, int batch, int n,
                   int npoint, long long* out, cudaStream_t stream) {
  auto kernel = fps_kernel<kThreads, kPer, kRegs>;
  const size_t smem = 16 * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, smem, stream>>>(xyz, mask, n, npoint, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int reart_fps(const float* xyz, const bool* mask, int batch, int n,
                         int npoint, long long* out, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxPoints || npoint < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // the fewest points a thread that cover N, all in registers: 256 threads
  // up to 2048 points, 512 past (measured on an H100: the cross-warp step
  // against the points a thread walks); past 8192, 1024 threads with the
  // running distances in registers and the coordinates in shared memory
  cudaError_t err;
  if (n <= 256) {
    err = launch<256, 1, true>(xyz, mask, batch, n, npoint, out, s);
  } else if (n <= 512) {
    err = launch<256, 2, true>(xyz, mask, batch, n, npoint, out, s);
  } else if (n <= 1024) {
    err = launch<256, 4, true>(xyz, mask, batch, n, npoint, out, s);
  } else if (n <= 2048) {
    err = launch<256, 8, true>(xyz, mask, batch, n, npoint, out, s);
  } else if (n <= 4096) {
    err = launch<512, 8, true>(xyz, mask, batch, n, npoint, out, s);
  } else if (n <= 8192) {
    err = launch<512, 16, true>(xyz, mask, batch, n, npoint, out, s);
  } else {
    err = launch<1024, 16, false>(xyz, mask, batch, n, npoint, out, s);
  }
  return static_cast<int>(err);
}
