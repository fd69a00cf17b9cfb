// Fused bidirectional 1-NN with the winners' coordinates, both ways.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn1_bidir_coords_pallas /
// _nn1c_bidir_kernel. For src (B, N, 3) and tgt (B, M, 3), float32:
//   forward  (per src point): squared distance to, index of, and coords of
//            its nearest tgt point -> fd (B, N), fi (B, N), fc (B, N, 3);
//   reverse  (per tgt point): the same against src -> bd, bi, bc.
// Distances are channel-wise diff^2, summed (dx^2 + dy^2) + dz^2 (the
// Pallas kernel's _sqdist_tile order); ties go to the lowest index.
//
// What bounds it on an H100: float32 issue rate (nn_split.cuh): 151M
// (src, tgt) pairs at (9, 4096, 4096), each distance computed once and
// reduced along both axes, as the TPU kernel does.
//
// Design (nn_split.cuh): one pass over the (N, M) plane. A block of 256
// threads takes 128 src rows x 512 tgt columns; the grid is (N / 128,
// M / 512, B). The block's columns are staged in shared memory; each thread
// keeps 16 src rows (rows r0 + ty + 8 r) in registers and walks 4 columns a
// step (c + tx + 32 k), so each distance feeds its row's and its column's
// running minimum, both kept with strict '<' in ascending index. A step's
// column minima are merged over the 8 lanes that share the columns by
// shuffles, the row minima at the end over the 4 thread columns of a warp by
// shuffles and over the 8 warps in shared memory, all on (distance, index)
// keys; each block then posts one 64-bit atomicMin per row and per column
// of its tile to the (B, N) and (B, M) key buffers. A second kernel decodes
// the keys (the distance is the key's upper 32 bits, exactly) and copies
// the winners' coordinates. Rows and columns past N or M are NaN, which
// never wins a '<'. A call makes four device launches: two memsets of the
// key buffers to all ones, the scan and the decode. Built with -fmad=false
// so no sum is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>

#include "nn_split.cuh"

namespace {

using nn_split::Key;

constexpr int kThreads = 256;
constexpr int kTY = 8;                // thread rows: lanes 0-7 of a group
constexpr int kTX = kThreads / kTY;   // 32 thread columns, 4 a warp
constexpr int kRT = 16;               // src rows of a thread
constexpr int kCT = 4;                // tgt columns of a thread a step
constexpr int kRows = kTY * kRT;      // 128 src rows a block
constexpr int kStep = kTX * kCT;      // 128 tgt columns a step
constexpr int kCols = 512;            // tgt columns a block
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads, 2)
nn1_bidir_scan_kernel(const float* __restrict__ src,
                      const float* __restrict__ tgt, int n, int m,
                      Key* __restrict__ fkey, Key* __restrict__ bkey) {
  __shared__ float4 s_tgt[kCols];
  __shared__ Key s_row[kWarps][kRows];

  const int b = blockIdx.z;
  const float* sp = src + (size_t)b * n * 3;
  const float* tp = tgt + (size_t)b * m * 3;
  const int r0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = lane % kTY;
  const int tx = warp * (32 / kTY) + lane / kTY;

  for (int e = threadIdx.x; e < kCols; e += kThreads) {
    const int c = c0 + e;
    float4 v = make_float4(NAN, NAN, NAN, 0.f);
    if (c < m) v = make_float4(tp[3 * c], tp[3 * c + 1], tp[3 * c + 2], 0.f);
    s_tgt[e] = v;
  }
  float sx[kRT], sy[kRT], sz[kRT], rd[kRT];
  int rj[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = r0 + ty + kTY * r;
    sx[r] = sy[r] = sz[r] = NAN;
    if (row < n) {
      sx[r] = sp[3 * row];
      sy[r] = sp[3 * row + 1];
      sz[r] = sp[3 * row + 2];
    }
    rd[r] = INFINITY;
    rj[r] = 0;
  }
  __syncthreads();

  const int ncols = min(kCols, m - c0);
  for (int c = 0; c < ncols; c += kStep) {
    Key ck[kCT];
#pragma unroll
    for (int k = 0; k < kCT; ++k) {
      const int e = c + tx + kTX * k;
      const float4 p = s_tgt[e];
      float cd = INFINITY;
      int cr = 0;  // the thread's row slot: row r0 + ty + kTY * cr
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float d = nn_split::sqdist(sx[r], sy[r], sz[r], p.x, p.y, p.z);
        if (d < rd[r]) {
          rd[r] = d;
          rj[r] = c0 + e;
        }
        if (d < cd) {
          cd = d;
          cr = r;
        }
      }
      ck[k] = nn_split::lane_min<kTY - 1>(
          nn_split::make_key(cd, r0 + ty + kTY * cr));
    }
    if (ty == 0) {
#pragma unroll
      for (int k = 0; k < kCT; ++k) {
        const int col = c0 + c + tx + kTX * k;
        if (col < m) atomicMin(&bkey[(size_t)b * m + col], ck[k]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const Key k = nn_split::lane_min<31 & ~(kTY - 1)>(
        nn_split::make_key(rd[r], rj[r]));
    if (lane < kTY) s_row[warp][ty + kTY * r] = k;
  }
  __syncthreads();
  if (threadIdx.x < kRows && r0 + (int)threadIdx.x < n) {
    Key k = s_row[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) k = nn_split::key_min(k, s_row[w][threadIdx.x]);
    atomicMin(&fkey[(size_t)b * n + r0 + threadIdx.x], k);
  }
}

// One thread per src point (forward) and per tgt point (reverse).
__global__ void nn1_bidir_decode_kernel(
    const float* __restrict__ src, const float* __restrict__ tgt, int batch,
    int n, int m, const Key* __restrict__ fkey, const Key* __restrict__ bkey,
    float* __restrict__ fd, long long* __restrict__ fi,
    float* __restrict__ fc, float* __restrict__ bd,
    long long* __restrict__ bi, float* __restrict__ bc) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nf = (size_t)batch * n;
  const size_t nb = (size_t)batch * m;
  const bool rev = t >= nf;
  const size_t o = rev ? t - nf : t;
  if (o >= (rev ? nb : nf)) return;
  const int nq = rev ? m : n;
  const int nr = rev ? n : m;
  const Key k = (rev ? bkey : fkey)[o];
  const int j = nn_split::key_index(k);
  (rev ? bd : fd)[o] = nn_split::key_dist(k);
  (rev ? bi : fi)[o] = j;
  const float* w = (rev ? src : tgt) + 3 * ((o / nq) * nr + j);
  float* oc = rev ? bc : fc;
  oc[3 * o] = w[0];
  oc[3 * o + 1] = w[1];
  oc[3 * o + 2] = w[2];
}

}  // namespace

// fkey (B, N) and bkey (B, M): 64-bit scratch that the wrapper allocates.
extern "C" int reart_nn1_bidir_coords(const float* src, const float* tgt,
                                      int batch, int n, int m, float* fd,
                                      long long* fi, float* fc, float* bd,
                                      long long* bi, float* bc, Key* fkey,
                                      Key* bkey, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nf = (size_t)batch * n;
  const size_t nb = (size_t)batch * m;
  cudaError_t err = cudaMemsetAsync(fkey, 0xff, nf * sizeof(Key), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(bkey, 0xff, nb * sizeof(Key), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, (m + kCols - 1) / kCols, batch);
  nn1_bidir_scan_kernel<<<grid, kThreads, 0, st>>>(src, tgt, n, m, fkey,
                                                   bkey);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = nf + nb;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  nn1_bidir_decode_kernel<<<blocks, 256, 0, st>>>(src, tgt, batch, n, m, fkey,
                                                  bkey, fd, fi, fc, bd, bi,
                                                  bc);
  return static_cast<int>(cudaGetLastError());
}
