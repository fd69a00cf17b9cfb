// Single-direction 1-NN with the winner's coordinates.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn1_coords_pallas / _nn1c_kernel. For
// query (B, N, 3) and ref (B, M, 3), float32:
//   out_d (B, N):    squared distance to the nearest reference point;
//   out_i (B, N):    its int64 index;
//   out_c (B, N, 3): its coordinates (what the Chamfer gradient needs, so
//                    the caller issues no gather afterwards).
// Distances are (dx^2 + dy^2) + dz^2 of query - ref; ties go to the lowest
// index.
//
// What bounds it on an H100: at the graph stage's shape, (P^2, 20, 20) for
// P <= 20 parts of 20 anchors each, the work is 160k pairs and 200 KB: the
// launch itself is the cost, so all pairs go in one launch and nothing in
// it waits on a barrier. At cloud scale ((9, 4096, 4096), 151M pairs) the
// float32 instruction rate, as for nn_topk.
//
// Design, two routes (the wrapper picks one: ops/cuda_nn.nn1_coords_plan):
//   * packed, N and M <= 32: a group of W lanes (W = 8, 16 or 32, the
//     power of two that holds both clouds) per cloud pair, 32 / W pairs a
//     warp, several warps a block. Lane s holds query point s and reference
//     point s in registers; the reference points go to every lane of the
//     group by __shfl_sync in ascending index, and a strict '<' keeps the
//     first of equal distances. The winner's coordinates come from its lane
//     by one more shuffle each. No shared memory, no barrier.
//   * topk, larger clouds: nn_topk.cu's k = 1 kernel (slices, queries a
//     thread, the subtile minimum; its plan from ops/cuda_nn.nn_topk_plan),
//     then one thread a query copies its winner's coordinates.
// Built with -fmad=false so every sum rounds as the plain version's.

#include <cuda_runtime.h>
#include <math.h>

#include "nn_split.cuh"

// csrc/nn_topk.cu, the topk route
extern "C" int reart_nn_topk(const float* query, const float* ref, int batch,
                             int n, int m, int k_out, int qpt, int slices,
                             float* out_d, long long* out_i, void* stream);

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(256)
nn1_coords_packed_kernel(const float* __restrict__ query,
                         const float* __restrict__ ref, int batch, int n,
                         int m, float* __restrict__ out_d,
                         long long* __restrict__ out_i,
                         float* __restrict__ out_c) {
  const size_t pair = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / W;
  const int s = threadIdx.x % W;
  const bool live = pair < (size_t)batch;
  float qx = NAN, qy = NAN, qz = NAN, rx = 0.f, ry = 0.f, rz = 0.f;
  if (live && s < n) {
    const float* q = query + 3 * (pair * n + s);
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  if (live && s < m) {
    const float* r = ref + 3 * (pair * m + s);
    rx = r[0];
    ry = r[1];
    rz = r[2];
  }
  float best = INFINITY;
  int bj = 0;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const float px = __shfl_sync(kFull, rx, j, W);
    const float py = __shfl_sync(kFull, ry, j, W);
    const float pz = __shfl_sync(kFull, rz, j, W);
    const float d = nn_split::sqdist(qx, qy, qz, px, py, pz);
    if (d < best) {  // strict: the first of equal distances stays
      best = d;
      bj = j;
    }
  }
  const float cx = __shfl_sync(kFull, rx, bj, W);
  const float cy = __shfl_sync(kFull, ry, bj, W);
  const float cz = __shfl_sync(kFull, rz, bj, W);
  if (!live || s >= n) return;
  const size_t o = pair * n + s;
  out_d[o] = best;
  out_i[o] = bj;
  out_c[3 * o] = cx;
  out_c[3 * o + 1] = cy;
  out_c[3 * o + 2] = cz;
}

// one thread a query: the coordinates of its winner out_i
__global__ void nn1_coords_gather_kernel(const float* __restrict__ ref,
                                         int batch, int n, int m,
                                         const long long* __restrict__ idx,
                                         float* __restrict__ out_c) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (size_t)batch * n) return;
  const float* p = ref + 3 * ((o / n) * m + idx[o]);
  out_c[3 * o] = p[0];
  out_c[3 * o + 1] = p[1];
  out_c[3 * o + 2] = p[2];
}

template <int W>
int launch_packed(const float* query, const float* ref, int batch, int n,
                  int m, int warps, float* out_d, long long* out_i,
                  float* out_c, cudaStream_t s) {
  const size_t pairs_a_block = (size_t)warps * (32 / W);
  const size_t blocks = (batch + pairs_a_block - 1) / pairs_a_block;
  nn1_coords_packed_kernel<W><<<(unsigned)blocks, 32 * warps, 0, s>>>(
      query, ref, batch, n, m, out_d, out_i, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route 0, packed: a = lanes a pair (8, 16 or 32, >= N and M), b = warps a
// block (1-8); route 1, topk: a = queries a thread, b = slices, as
// reart_nn_topk takes them.
extern "C" int reart_nn1_coords(const float* query, const float* ref,
                                int batch, int n, int m, int route, int a,
                                int b, float* out_d, long long* out_i,
                                float* out_c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (n > a || m > a || b < 1 || b > 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (a == 8)
      return launch_packed<8>(query, ref, batch, n, m, b, out_d, out_i,
                              out_c, s);
    if (a == 16)
      return launch_packed<16>(query, ref, batch, n, m, b, out_d, out_i,
                               out_c, s);
    if (a == 32)
      return launch_packed<32>(query, ref, batch, n, m, b, out_d, out_i,
                               out_c, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = reart_nn_topk(query, ref, batch, n, m, 1, a, b, out_d,
                                out_i, stream);
  if (err != 0) return err;
  const size_t total = (size_t)batch * n;
  nn1_coords_gather_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      ref, batch, n, m, out_i, out_c);
  return static_cast<int>(cudaGetLastError());
}
