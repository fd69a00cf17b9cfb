"""The backbone's fused batch-mode BatchNorm (ops/cuda_bn.py,
csrc/batch_norm.cu): the written-out form's numbers, bit for bit.

On the CPU: the plain route of `batch_norm_relu` (autograd's own chain of
the written-out form, its row sums ATen's) against autograd of the
written-out form, bit for bit in float32 and float64, and against numerical
derivatives (gradcheck); and `ConvBN`'s CPU route, which stays the
written-out form.

On the card (marked `cuda`, skipping without a device; decided in the
`cuda` fixture, not at import): the kernels against autograd of the
written-out form, bit for bit, at every layer shape of the corr cell's step
and at row counts that are no power of two; the whole backbone's batch-mode
step the same; the launch and `bn.fused` counters; the routes that do not
launch (float64, bfloat16, running mode) and the inputs the kernels refuse.
On a machine with a card and no jax run

    python -m pytest --noconftest -m cuda tests/test_torch_bn.py -q
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from reart_tpu_torch import profiling
from reart_tpu_torch.models import pointnet2
from reart_tpu_torch.ops import cuda_bn

torch.set_num_threads(1)

# the (lin shape, C_in) of the 25 conv + BN layers of one corr step: 2B = 8
# clouds of 1024 points; SA1 512 centroids x 32 / 64 / 128 neighbours, SA2
# 128 x 64 / 128, SA3 over 128 points, FP3 at 128, FP2 at 512, FP1 and the
# head at 1024 points a cloud
CELL_LAYERS = (
    [((8, 512, 32, c), i) for i, c in ((6, 32), (32, 32), (32, 64))]
    + [((8, 512, 64, c), i) for i, c in ((6, 64), (64, 64), (64, 128))]
    + [((8, 512, 128, c), i) for i, c in ((6, 64), (64, 96), (96, 128))]
    + [((8, 128, 64, c), i) for i, c in ((323, 128), (128, 128), (128, 256))]
    + [((8, 128, 128, c), i) for i, c in ((323, 128), (128, 196),
                                          (196, 256))]
    + [((8, 1, 128, c), i) for i, c in ((515, 256), (256, 512), (512, 1024))]
    + [((8, 128, c), i) for i, c in ((1536, 256), (256, 256))]
    + [((8, 512, c), i) for i, c in ((576, 256), (256, 128))]
    + [((8, 1024, c), i) for i, c in ((134, 128), (128, 128), (128, 64))])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def written_out(lin, bias, bn_weight, bn_bias, relu=True):
    """ConvBN's written-out batch mode: (out, mean, var)."""
    z = lin + bias
    axes = tuple(range(z.dim() - 1))
    mean = torch.mean(z, dim=axes)
    var = torch.var(z, dim=axes, unbiased=False)
    y = (z - mean) / torch.sqrt(var + pointnet2.BN_EPS)
    y = y * bn_weight + bn_bias
    return (F.relu(y) if relu else y), mean, var


def _layer(shape, c_in, seed, device, dtype=torch.float32):
    """lin = F.linear(x, W) of a layer: x >= 0 as after a ReLU (the first
    layers' centred coordinates aside), W and the bias as torch's Conv
    default draws them, the affine away from (1, 0); and an upstream
    gradient."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    kw = dict(generator=g, device=device, dtype=dtype)
    x = torch.randn(shape[:-1] + (c_in,), **kw)
    if c_in > 6:
        x = torch.relu(x)
    bound = 1.0 / np.sqrt(c_in)
    lin = F.linear(x, (2 * torch.rand((c, c_in), **kw) - 1) * bound)
    bias = (2 * torch.rand(c, **kw) - 1) * bound
    bn_w = 0.5 + torch.rand(c, **kw)
    bn_b = 0.2 * torch.randn(c, **kw)
    grad = torch.randn(shape, **kw)
    return [t.requires_grad_() for t in (lin, bias, bn_w, bn_b)], grad


def _both(args, grad, relu):
    """(the Function's, the written-out form's): each (out, mean, var, the
    gradients of the four inputs) for the upstream gradient `grad`."""
    res = []
    for fn in (cuda_bn.batch_norm_relu, written_out):
        out, mean, var = fn(*args, relu)
        grads = torch.autograd.grad(out, args, grad)
        res.append((out.detach(), mean.detach(), var.detach()) + grads)
    return res


def _assert_bit_equal(got, want):
    names = ("out", "mean", "var", "grad lin", "grad bias",
             "grad bn_weight", "grad bn_bias")
    for name, a, b in zip(names, got, want):
        assert torch.equal(a, b), name


# rows 105, 37 and 128: multiples of no step of the kernels' layout but one
CPU_SHAPES = [(3, 7, 5, 8), (37, 12), (2, 1, 64, 4)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_plain_backward_passes_gradcheck(shape, relu):
    args, _ = _layer(shape, 5, seed=sum(shape), device="cpu",
                     dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: cuda_bn.batch_norm_relu(*a, relu)[0], args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_plain_route_is_autograd_of_the_written_out_form(shape, relu, dtype):
    args, grad = _layer(shape, 5, seed=7 + sum(shape), device="cpu",
                        dtype=dtype)
    got, want = _both(args, grad, relu)
    _assert_bit_equal(got, want)
    assert not any(t.requires_grad for t in cuda_bn.batch_norm_relu(
        *args, relu)[1:])


def test_convbn_on_the_cpu_stays_written_out():
    """A CPU ConvBN in batch mode computes the written-out form bit for bit,
    launches nothing and counts no fused BatchNorm."""
    torch.manual_seed(0)
    layer = pointnet2.ConvBN(6, 8, device="cpu")
    with torch.no_grad():
        layer.bn_weight.uniform_(0.5, 1.5)
        layer.bn_bias.uniform_(-0.2, 0.2)
    x = torch.randn(2, 16, 5, 6)
    before = (cuda_bn.bn_forward.launches, cuda_bn.bn_backward.launches)
    with profiling.tracing():
        stats = []
        out = layer(x, bn_mode="batch", stats_out=stats)
        out.sum().backward()
        counters = profiling.snapshot()["counters"]
    ref, mean, var = written_out(F.linear(x, layer.weight), layer.bias,
                                 layer.bn_weight, layer.bn_bias)
    assert torch.equal(out, ref)
    assert torch.equal(stats[0][0], mean) and torch.equal(stats[0][1], var)
    assert "bn.fused" not in counters
    assert (cuda_bn.bn_forward.launches,
            cuda_bn.bn_backward.launches) == before


def test_shape_checks():
    (lin, bias, w, b), grad = _layer((4, 8), 3, seed=0, device="cpu")
    with pytest.raises(ValueError):
        cuda_bn.bn_forward(lin, bias[:4], w, b, True)
    with pytest.raises(ValueError):
        cuda_bn.bn_forward(lin[:0], bias, w, b, True)
    _, z, mean, var = cuda_bn.bn_forward(lin, bias, w, b, True)
    with pytest.raises(ValueError):
        cuda_bn.bn_backward(grad[:2], z, mean, var, w, b, True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,c_in", CELL_LAYERS)
def test_kernels_are_the_written_out_form_bit_for_bit(cuda, shape, c_in,
                                                      relu):
    args, grad = _layer(shape, c_in, seed=sum(shape) + c_in, device=cuda)
    got, want = _both(args, grad, relu)
    _assert_bit_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1000, 64), (7, 33, 4), (1, 1, 1024),
                                   (5, 77, 196)])
def test_kernels_bit_for_bit_at_rows_of_no_power_of_two(cuda, shape):
    """1 / R and 2 / R are rounded as ATen rounds them; ragged row steps."""
    args, grad = _layer(shape, 16, seed=shape[1], device=cuda)
    got, want = _both(args, grad, True)
    _assert_bit_equal(got, want)


@pytest.mark.cuda
def test_two_calls_are_bit_equal(cuda):
    args, grad = _layer((8, 512, 128, 128), 96, seed=5, device=cuda)
    first, second = _both(args, grad, True)[0], _both(args, grad, True)[0]
    _assert_bit_equal(first, second)


def _backbone_step(model, xyz):
    stats = []
    feats = model(xyz, bn_mode="batch", stats_out=stats)
    loss = (feats * torch.linspace(-1, 1, feats.numel(), device=xyz.device)
            .reshape(feats.shape)).sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return [feats] + [t for pair in stats for t in pair] + list(grads)


@pytest.mark.cuda
def test_the_backbone_step_is_the_written_out_forms(cuda, monkeypatch):
    """The batch-mode forward and backward of PointNet2Msg2 (2 x 1024
    points) through the kernels: features, every layer's moments and every
    parameter's gradient equal the written-out form's bit for bit; 25
    forwards and 25 backwards launched, `bn.fused` 50, 50 `bn` spans."""
    model = pointnet2.PointNet2Msg2(
        device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, device=cuda))
    xyz = torch.rand((2, 1024, 3), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    f0, b0 = cuda_bn.bn_forward.launches, cuda_bn.bn_backward.launches
    with profiling.tracing():
        fused = _backbone_step(model, xyz)
        snap = profiling.snapshot()
    assert snap["counters"]["bn.fused"] == 50
    assert (snap["launches"]["bn_forward"],
            snap["launches"]["bn_backward"]) == (25, 25)
    assert (cuda_bn.bn_forward.launches - f0,
            cuda_bn.bn_backward.launches - b0) == (25, 25)
    assert sum(s["name"] == "bn" for s in snap["spans"]) == 50
    monkeypatch.setattr(pointnet2, "batch_norm_relu", written_out)
    plain = _backbone_step(model, xyz)
    assert len(fused) == len(plain) == 1 + 2 * 25 + 4 * 25
    for i, (a, b) in enumerate(zip(fused, plain)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_float64_bfloat16_and_running_mode_stay_written_out(cuda):
    """On the card, float64 (the parity tests' mode), bfloat16 under
    autocast and running mode compute the written-out form bit for bit and
    launch nothing."""
    torch.manual_seed(0)
    layer = pointnet2.ConvBN(64, 128, device=cuda)
    with torch.no_grad():
        layer.running_mean.uniform_(-0.5, 0.5)
        layer.running_var.uniform_(0.5, 2.0)
    x = torch.relu(torch.randn(4096, 64, device=cuda))
    before = (cuda_bn.bn_forward.launches, cuda_bn.bn_backward.launches)

    out = layer(x, bn_mode="running")
    out.sum().backward()
    y = ((F.linear(x, layer.weight) + layer.bias - layer.running_mean)
         / torch.sqrt(layer.running_var + pointnet2.BN_EPS))
    assert torch.equal(out, F.relu(y * layer.bn_weight + layer.bn_bias))
    double = pointnet2.ConvBN(64, 128, device=cuda).double()
    out = double(x.double(), bn_mode="batch")
    out.sum().backward()
    assert torch.equal(out, written_out(
        F.linear(x.double(), double.weight), double.bias, double.bn_weight,
        double.bn_bias)[0])
    with torch.autocast(device_type="cuda", dtype=torch.bfloat16):
        out = layer(x, bn_mode="batch")
        want = written_out(F.linear(x, layer.weight), layer.bias,
                           layer.bn_weight, layer.bn_bias)[0]
    out.float().sum().backward()
    assert torch.equal(out, want)
    assert (cuda_bn.bn_forward.launches,
            cuda_bn.bn_backward.launches) == before


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_do_not_take(cuda):
    (lin, bias, w, b), grad = _layer((1024, 64), 16, seed=3, device=cuda)
    lin, bias, w, b = (t.detach() for t in (lin, bias, w, b))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bn.bn_forward(lin.t().contiguous().t(), bias, w, b, True)
    with pytest.raises(ValueError, match="float32"):
        cuda_bn.bn_forward(lin.double(), bias.double(), w.double(),
                           b.double(), True)
    for c in (6, 2 * cuda_bn.MAX_C):
        args, _ = _layer((256, c), 8, seed=c, device=cuda)
        with pytest.raises(ValueError, match="C % 4"):
            cuda_bn.bn_forward(*(a.detach() for a in args), True)
    _, z, mean, var = cuda_bn.bn_forward(lin, bias, w, b, True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bn.bn_backward(grad.t().contiguous().t(), z, mean, var, w, b,
                            True)
