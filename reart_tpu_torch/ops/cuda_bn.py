"""Batch-mode BatchNorm of the backbone's 1x1 convolutions, with the conv's
bias and the ReLU, as one autograd Function whose elementwise work is
hand-written kernels (csrc/batch_norm.cu), with its plain PyTorch version.
Replaces no TPU kernel: the JAX package writes BatchNorm out and leaves its
fusion to XLA.

For lin = F.linear(x, weight) (..., C) without the bias, the conv's `bias`
and BatchNorm's `bn_weight` / `bn_bias`:

    z = lin + bias; mean, var = the moments of z over every axis but the
    last (var biased); out = relu((z - mean) / sqrt(var + 1e-5)
    * bn_weight + bn_bias)

The result is the written-out form's, bit for bit, forward and backward:
every elementwise operation is rounded as ATen rounds it, the sums over the
rows are ATen's own reductions on the same tensors (mean, var, and the
five row sums of the backward), and the backward is autograd's chain of the
written-out form, node by node, with its terms added in the order autograd
adds them. The plain version is that chain in ATen operations; the kernels
do its elementwise passes in four launches (forward: the bias add, the
normalisation; backward: the four terms the row sums read, the input's
gradient), in place of some thirty ATen kernels.

`batch_norm_relu` is the Function; its halves `bn_forward` and
`bn_backward` take the plain version for a CPU tensor and launch the
kernels for a CUDA tensor (float32, contiguous, C % 4 == 0 and C <= 1024,
or they raise). `.launches` counts each half's calls (two launches each),
and the profiling counter `bn.fused` one for each forward and each backward
of the Function. Who takes this route is models/pointnet2.ConvBN's choice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F

from reart_tpu_torch.ops import _build
from reart_tpu_torch.profiling import count

BN_EPS = 1e-5
THREADS = 256    # the kernels' block size
MAX_C = 4 * THREADS
# blocks a streaming multiprocessor: the grid of every launch, at most
BLOCKS_PER_SM = 8


def _axes(t):
    return tuple(range(t.dim() - 1))


def normalize_plain(z: torch.Tensor, mean, var, bn_weight, bn_bias,
                    relu: bool):
    """The written-out normalisation, in either BatchNorm mode:
    relu((z - mean) / sqrt(var + eps) * bn_weight + bn_bias)."""
    y = (z - mean) / torch.sqrt(var + BN_EPS)
    y = y * bn_weight + bn_bias
    return F.relu(y) if relu else y


def bn_forward_plain(lin: torch.Tensor, bias, bn_weight, bn_bias,
                     relu: bool):
    """lin (..., C) -> (out, z = lin + bias, mean, var): the written-out
    form."""
    z = lin + bias
    mean = torch.mean(z, dim=_axes(z))
    var = torch.var(z, dim=_axes(z), unbiased=False)
    return normalize_plain(z, mean, var, bn_weight, bn_bias, relu), z, \
        mean, var


def _grad_terms_plain(grad, z, mean, var, bn_weight, bn_bias, relu):
    """The four tensors autograd sums over the rows, as autograd computes
    them: g_y (ReluBackward), g_y t4 (MulBackward's weight side), g_q (t4 /
    s) (DivBackward's divisor side, before its sign), g_d (DivBackward's
    dividend side)."""
    s = torch.sqrt(var + BN_EPS)
    t4 = (z - mean) / s
    if relu:
        out = F.relu(t4 * bn_weight + bn_bias)
        grad = torch.ops.aten.threshold_backward(grad, out, 0)
    g_q = grad * bn_weight
    return grad, grad * t4, g_q * (t4 / s), g_q / s


def _grad_input_plain(g_d, z, mean, var, sum_s, sum_d):
    """grad z = (g_d + (2 / R) (-S_s / (2 s)) (z - mean)) + (-S_d) / R:
    SubBackward, VarBackward and MeanBackward, in the engine's order."""
    rows = z.numel() // z.shape[-1]
    g_var = -sum_s / (2 * torch.sqrt(var + BN_EPS))
    return (g_d + ((2.0 / rows) * g_var) * (z - mean)) + (-sum_d).expand(
        z.shape) / rows


def bn_backward_plain(grad: torch.Tensor, z: torch.Tensor, mean, var,
                      bn_weight, bn_bias, relu: bool):
    """(grad z, (grad bias, grad bn_weight, grad bn_bias) each (C,)), as
    autograd computes them for the written-out form."""
    axes = _axes(z)
    g_y, g_yt, g_s, g_d = _grad_terms_plain(grad, z, mean, var, bn_weight,
                                            bn_bias, relu)
    sums = [t.sum(axes) for t in (g_y, g_yt, g_s, g_d)]
    g_z = _grad_input_plain(g_d, z, mean, var, sums[2], sums[3])
    return g_z, (g_z.sum(axes), sums[1], sums[0])


def _check(name, lin, *params):
    c = lin.shape[-1] if lin.dim() else 0
    if not c or any(p.shape != (c,) for p in params):
        raise ValueError(f"{name}: expected (..., C) and parameters (C,), "
                         f"got {tuple(lin.shape)} and "
                         f"{[tuple(p.shape) for p in params]}")
    if lin.numel() == 0:
        raise ValueError(f"{name}: no rows")


def _launch_shape(name, t):
    """(rows, C, blocks) of a CUDA tensor the kernels take, or raise."""
    c = t.shape[-1]
    if c % 4 or not 4 <= c <= MAX_C:
        raise ValueError(f"{name}: the kernels take C % 4 == 0 and "
                         f"4 <= C <= {MAX_C}, got C = {c}")
    rows = t.numel() // c
    if rows > 2**31 - 1:
        raise ValueError(f"{name}: {rows} rows is past the kernels' int")
    rpi = THREADS // (c // 4)
    blocks = min(-(-rows // rpi), BLOCKS_PER_SM * _build.sm_count(t.device))
    return rows, c, blocks


@functools.lru_cache(maxsize=None)
def _row_scales(rows: int) -> tuple[float, float]:
    """VarBackward's 2 / R and MeanBackward's 1 / R as ATen rounds them: the
    first a double rounded to float, the second a float division."""
    return 2.0 / rows, float(np.float32(1.0) / np.float32(rows))


def bn_forward(lin: torch.Tensor, bias, bn_weight, bn_bias, relu: bool):
    """The Function's forward: (out, z, mean, var); see bn_forward_plain."""
    name = "bn_forward"
    _check(name, lin, bias, bn_weight, bn_bias)
    if _build.is_cpu(name, lin):
        return bn_forward_plain(lin, bias, bn_weight, bn_bias, relu)
    _build.require_cuda(name, lin, bias, bn_weight, bn_bias,
                        dtype=torch.float32)
    rows, c, blocks = _launch_shape(name, lin)
    lib = _build.load_library()
    z = torch.empty_like(lin)
    with torch.cuda.device(lin.device):
        stream = _build.stream_of(lin)
        _build.check_launch(name, lib.reart_bn_bias_add(
            lin.data_ptr(), bias.data_ptr(), rows, c, blocks, z.data_ptr(),
            stream))
        mean = torch.mean(z, dim=_axes(z))
        var = torch.var(z, dim=_axes(z), unbiased=False)
        out = torch.empty_like(z)
        _build.check_launch(name, lib.reart_bn_apply(
            z.data_ptr(), mean.data_ptr(), var.data_ptr(),
            bn_weight.data_ptr(), bn_bias.data_ptr(), rows, c, int(relu),
            blocks, out.data_ptr(), stream))
    bn_forward.launches += 1
    return out, z, mean, var


bn_forward.launches = 0


def bn_backward(grad: torch.Tensor, z: torch.Tensor, mean, var, bn_weight,
                bn_bias, relu: bool):
    """The Function's backward: (grad z, (grad bias, grad bn_weight, grad
    bn_bias)); see bn_backward_plain."""
    name = "bn_backward"
    _check(name, z, mean, var, bn_weight, bn_bias)
    if grad.shape != z.shape:
        raise ValueError(f"{name}: grad {tuple(grad.shape)} for "
                         f"{tuple(z.shape)}")
    if _build.is_cpu(name, z):
        return bn_backward_plain(grad, z, mean, var, bn_weight, bn_bias, relu)
    _build.require_cuda(name, grad, z, mean, var, bn_weight, bn_bias,
                        dtype=torch.float32)
    rows, c, blocks = _launch_shape(name, z)
    axes = _axes(z)
    lib = _build.load_library()
    terms = torch.empty((4,) + tuple(z.shape), dtype=z.dtype,
                        device=z.device)
    with torch.cuda.device(z.device):
        stream = _build.stream_of(z)
        _build.check_launch(name, lib.reart_bn_grad_terms(
            grad.data_ptr(), z.data_ptr(), mean.data_ptr(), var.data_ptr(),
            bn_weight.data_ptr(), bn_bias.data_ptr(), rows, c, int(relu),
            blocks, terms.data_ptr(), stream))
        g_b, g_w, sum_s, sum_d = (t.sum(axes) for t in terms.unbind(0))
        g_z = torch.empty_like(z)
        g_d = terms.data_ptr() + 3 * z.numel() * z.element_size()
        _build.check_launch(name, lib.reart_bn_grad_input(
            g_d, z.data_ptr(), mean.data_ptr(), var.data_ptr(),
            sum_s.data_ptr(), sum_d.data_ptr(), rows, c, *_row_scales(rows),
            blocks, g_z.data_ptr(), stream))
        g_bias = g_z.sum(axes)
    bn_backward.launches += 1
    return g_z, (g_bias, g_w, g_b)


bn_backward.launches = 0


class _BatchNormReLU(torch.autograd.Function):
    """(lin, bias, bn_weight, bn_bias, relu) -> (out, mean, var); mean and
    var take no gradient. Saves z = lin + bias, the moments and the
    affine."""

    @staticmethod
    def forward(ctx, lin, bias, bn_weight, bn_bias, relu):
        out, z, mean, var = bn_forward(lin, bias, bn_weight, bn_bias, relu)
        count("bn.fused")
        ctx.save_for_backward(z, mean, var, bn_weight, bn_bias)
        ctx.relu = relu
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, grad_out, _grad_mean, _grad_var):
        if grad_out is None:
            return None, None, None, None, None
        z, mean, var, bn_weight, bn_bias = ctx.saved_tensors
        if not grad_out.is_contiguous():
            grad_out = grad_out.contiguous()
        g_z, (g_bias, g_weight, g_shift) = bn_backward(
            grad_out, z, mean, var, bn_weight, bn_bias, ctx.relu)
        count("bn.fused")
        return g_z, g_bias, g_weight, g_shift, None


def batch_norm_relu(lin: torch.Tensor, bias: torch.Tensor,
                    bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                    relu: bool = True):
    """lin (..., C) -> (out like lin, mean (C,), var (C,)): BatchNorm on
    the batch moments of lin + bias, with the ReLU when `relu`; see the
    module's docstring."""
    return _BatchNormReLU.apply(lin, bias, bn_weight, bn_bias, relu)
