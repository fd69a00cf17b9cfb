// Batch-mode BatchNorm of the backbone's 1x1 convolutions, with the conv's
// bias and the ReLU: the elementwise work of the forward and the backward
// over a channel-last (rows, C) float32 tensor, in four kernels
// (ops/cuda_bn.py). The per-channel sums stay ATen's reductions.
//
// Replaces no TPU kernel: the JAX package (reart_tpu/models/pointnet2.py)
// writes BatchNorm out and leaves it to XLA, which fuses it by itself. On
// the card the written-out form is a dozen ATen kernels forward and some
// twenty autograd nodes backward, most of them elementwise passes over the
// layer's tensor that broadcast a (C,) vector, which sends ATen to its
// generic, unvectorised elementwise path.
//
// What it computes is the written-out form's every rounding, bit for bit:
// forward z = lin + bias, then (ATen) mean and biased var of z over the
// rows, then out = relu(((z - mean) / sqrt(var + 1e-5)) * w + b), each
// operation rounded once as ATen rounds it (IEEE division and square root,
// no FMA contraction: -fmad=false; the ReLU as ATen's clamp_min, NaN kept).
// The backward is autograd's own chain of that form, node by node: with
// t4 = (z - mean) / s, s = sqrt(var + 1e-5), g_y = 0 where out <= 0 (else
// grad_out), g_q = g_y * w and g_d = g_q / s, the kernel writes the four
// terms autograd sums over the rows (g_y for b, g_y t4 for w,
// g_q ((z - mean) / s) / s for s, g_d for the mean); after ATen's sums,
// grad z = (g_d + (2 / R) (-S_s / (2 s)) (z - mean)) + (-S_d) (1 / R), the
// three terms added in the order autograd's engine adds them. So the
// trained weights are those of the written-out form to the last bit: a
// training run diverges from any other rounding within a few Adam steps.
//
// What bounds it on an H100: bytes. The least BatchNorm costs is eight
// passes over the layer's (R, C) float32 tensor (forward: read for the
// moments, read and write; backward: read grad_out and the input for two
// sums, read both again and write), 3.35 ms for the step's 25 layers at
// 3.35 TB/s. Keeping ATen's reductions and their order costs more: forward
// 6 passes (bias add 2, mean 1, var 1, apply 2), backward 14 (the four
// terms 2 + 4, their sums 4, grad z 3, the bias's sum 1).
//
// Design: every kernel is the same layout. 256 threads a block run along
// the contiguous channel axis in float4 loads and stores (C % 4 == 0), so a
// step of a block covers 256 / (C / 4) rows; blocks stride over the rows,
// each thread loading several steps ahead of its arithmetic, and a thread
// keeps its four channels' constants in registers for the whole launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4 * kThreads;
constexpr int kUnroll = 4;
// BN_EPS as ATen adds it to a float tensor: rounded to float once
constexpr float kEps = 1e-5f;

// This thread's place: its float4 column, its row within a block's step,
// and the rows a step covers (threads past them idle).
struct Lane {
  int col, sub, rpi;
  bool live;
};

__device__ __forceinline__ Lane lane_of(int c) {
  const int c4 = c >> 2;
  Lane l;
  l.rpi = kThreads / c4;
  l.col = threadIdx.x % c4;
  l.sub = threadIdx.x / c4;
  l.live = l.sub < l.rpi;
  return l;
}

__device__ __forceinline__ float4 load4(const float* p, long long row, int c,
                                        int col) {
  return __ldg(reinterpret_cast<const float4*>(p + row * c) + col);
}

__device__ __forceinline__ void store4(float* p, long long row, int c,
                                       int col, float4 v) {
  reinterpret_cast<float4*>(p + row * c)[col] = v;
}

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void put(float4& v, int k, float f) {
  if (k == 0) v.x = f; else if (k == 1) v.y = f; else if (k == 2) v.z = f;
  else v.w = f;
}

// The per-channel values of a thread's four channels: the mean, the
// divisor s = sqrt(var + eps) and the affine.
struct Channels {
  float m[4], s[4], w[4], b[4];
};

__device__ __forceinline__ Channels channels_of(const float* mean,
                                                const float* var,
                                                const float* w, const float* b,
                                                int col) {
  Channels ch;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * col + k;
    ch.m[k] = mean[i];
    ch.s[k] = sqrtf(var[i] + kEps);
    ch.w[k] = w[i];
    ch.b[k] = b[i];
  }
  return ch;
}

// ATen's relu (clamp_min(y, 0): NaN kept).
__device__ __forceinline__ float relu_of(float y) {
  return isnan(y) ? y : fmaxf(y, 0.f);
}

// The rows of a grid-stride launch, kUnroll steps of a block at a time:
// load(u, row) for each of them, then use(u, row), rows past `rows`
// skipped, so that every load of a thread is in flight before its first use.
template <typename Load, typename Use>
__device__ __forceinline__ void for_rows(const Lane& l, long long rows,
                                         Load load, Use use) {
  const long long span = static_cast<long long>(l.rpi) * kUnroll;
  for (long long r0 = blockIdx.x * span; r0 < rows; r0 += gridDim.x * span) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r0 + u * l.rpi + l.sub;
      if (row < rows) load(u, row);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r0 + u * l.rpi + l.sub;
      if (row < rows) use(u, row);
    }
  }
}

// z = lin + bias.
__global__ void __launch_bounds__(kThreads)
bn_bias_add_kernel(const float* __restrict__ lin,
                   const float* __restrict__ bias, long long rows, int c,
                   float* __restrict__ z) {
  const Lane l = lane_of(c);
  if (!l.live) return;
  float bb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bb[k] = bias[4 * l.col + k];
  float4 v[kUnroll];
  for_rows(
      l, rows, [&](int u, long long row) { v[u] = load4(lin, row, c, l.col); },
      [&](int u, long long row) {
        float4 o;
#pragma unroll
        for (int k = 0; k < 4; ++k) put(o, k, get(v[u], k) + bb[k]);
        store4(z, row, c, l.col, o);
      });
}

// out = relu(((z - mean) / s) * w + b).
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const float* __restrict__ z, const float* __restrict__ mean,
                const float* __restrict__ var, const float* __restrict__ w,
                const float* __restrict__ b, long long rows, int c, int relu,
                float* __restrict__ out) {
  const Lane l = lane_of(c);
  if (!l.live) return;
  const Channels ch = channels_of(mean, var, w, b, l.col);
  float4 v[kUnroll];
  for_rows(
      l, rows, [&](int u, long long row) { v[u] = load4(z, row, c, l.col); },
      [&](int u, long long row) {
        float4 o;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float y =
              ((get(v[u], k) - ch.m[k]) / ch.s[k]) * ch.w[k] + ch.b[k];
          put(o, k, relu ? relu_of(y) : y);
        }
        store4(out, row, c, l.col, o);
      });
}

// The four terms autograd reduces over the rows, into terms[4][rows][c]:
// g_y, g_y t4, g_q (t4 / s), g_d.
__global__ void __launch_bounds__(kThreads)
bn_grad_terms_kernel(const float* __restrict__ g, const float* __restrict__ z,
                     const float* __restrict__ mean,
                     const float* __restrict__ var,
                     const float* __restrict__ w, const float* __restrict__ b,
                     long long rows, int c, int relu,
                     float* __restrict__ terms) {
  const Lane l = lane_of(c);
  if (!l.live) return;
  const Channels ch = channels_of(mean, var, w, b, l.col);
  const long long plane = rows * c;
  float4 gv[kUnroll], zv[kUnroll];
  for_rows(
      l, rows,
      [&](int u, long long row) {
        gv[u] = load4(g, row, c, l.col);
        zv[u] = load4(z, row, c, l.col);
      },
      [&](int u, long long row) {
        float4 o0, o1, o2, o3;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float t4 = (get(zv[u], k) - ch.m[k]) / ch.s[k];
          const float y = t4 * ch.w[k] + ch.b[k];
          // ReluBackward: threshold_backward(grad, out, 0)
          const float gy = relu && relu_of(y) <= 0.f ? 0.f : get(gv[u], k);
          const float gq = gy * ch.w[k];
          put(o0, k, gy);
          put(o1, k, gy * t4);
          put(o2, k, gq * (t4 / ch.s[k]));
          put(o3, k, gq / ch.s[k]);
        }
        store4(terms, row, c, l.col, o0);
        store4(terms + plane, row, c, l.col, o1);
        store4(terms + 2 * plane, row, c, l.col, o2);
        store4(terms + 3 * plane, row, c, l.col, o3);
      });
}

// grad z = (g_d + k (z - mean)) + g3, with k = (2 / R) (-S_s / (2 s)) and
// g3 = (-S_d) (1 / R): S_s and S_d the row sums of terms 2 and 3.
__global__ void __launch_bounds__(kThreads)
bn_grad_input_kernel(const float* __restrict__ gd, const float* __restrict__ z,
                     const float* __restrict__ mean,
                     const float* __restrict__ var,
                     const float* __restrict__ sum_s,
                     const float* __restrict__ sum_d, long long rows, int c,
                     float two_over_r, float inv_r, float* __restrict__ gz) {
  const Lane l = lane_of(c);
  if (!l.live) return;
  float m[4], kv[4], g3[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * l.col + k;
    m[k] = mean[i];
    // SqrtBackward: grad / (2 * result); VarBackward: (2 / R) * grad
    const float gv = -sum_s[i] / (2.f * sqrtf(var[i] + kEps));
    kv[k] = two_over_r * gv;
    // MeanBackward: the expanded grad / R, as a product by 1 / R
    g3[k] = -sum_d[i] * inv_r;
  }
  float4 dv[kUnroll], zv[kUnroll];
  for_rows(
      l, rows,
      [&](int u, long long row) {
        dv[u] = load4(gd, row, c, l.col);
        zv[u] = load4(z, row, c, l.col);
      },
      [&](int u, long long row) {
        float4 o;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          put(o, k, (get(dv[u], k) + kv[k] * (get(zv[u], k) - m[k])) + g3[k]);
        store4(gz, row, c, l.col, o);
      });
}

int check(int rows, int c, int blocks) {
  if (rows < 1 || c < 4 || c > kMaxC || c % 4 != 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Every entry: one launch of `blocks` blocks on `stream`; tensors (rows, c)
// and (c), contiguous float32.
extern "C" int reart_bn_bias_add(const float* lin, const float* bias,
                                 int rows, int c, int blocks, float* z,
                                 void* stream) {
  if (const int err = check(rows, c, blocks)) return err;
  bn_bias_add_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(lin, bias, rows,
                                                            c, z);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int reart_bn_apply(const float* z, const float* mean,
                              const float* var, const float* w,
                              const float* b, int rows, int c, int relu,
                              int blocks, float* out, void* stream) {
  if (const int err = check(rows, c, blocks)) return err;
  bn_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, mean, var, w, b, rows, c, relu, out);
  return static_cast<int>(cudaGetLastError());
}

// terms: (4, rows, c).
extern "C" int reart_bn_grad_terms(const float* g, const float* z,
                                   const float* mean, const float* var,
                                   const float* w, const float* b, int rows,
                                   int c, int relu, int blocks, float* terms,
                                   void* stream) {
  if (const int err = check(rows, c, blocks)) return err;
  bn_grad_terms_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, z, mean, var, w, b, rows, c, relu, terms);
  return static_cast<int>(cudaGetLastError());
}

// gd: term 3 of reart_bn_grad_terms; sum_s, sum_d (c): the row sums of
// terms 2 and 3; two_over_r, inv_r: float(2 / rows), 1 / float(rows).
extern "C" int reart_bn_grad_input(const float* gd, const float* z,
                                   const float* mean, const float* var,
                                   const float* sum_s, const float* sum_d,
                                   int rows, int c, float two_over_r,
                                   float inv_r, int blocks, float* gz,
                                   void* stream) {
  if (const int err = check(rows, c, blocks)) return err;
  bn_grad_input_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      gd, z, mean, var, sum_s, sum_d, rows, c, two_over_r, inv_r, gz);
  return static_cast<int>(cudaGetLastError());
}
