"""PointNet++ MSG correspondence backbone (reart_tpu/models/pointnet2.py).

`PointNet2Msg2`: SA1 (512 centroids, radii 0.05 / 0.1 / 0.2 with 32 / 64 /
128 neighbours), SA2 (128 centroids, radii 0.2 / 0.4 with 64 / 128
neighbours), a global SA3, three feature-propagation layers and a 64-d head.
Channel-last throughout: xyz (B, N, 3) -> per-point features (B, N, out_dim);
the 1x1 convolutions are `F.linear` over the last axis. FPS starts at index 0
and the ball query keeps the first in-radius indices in point order, padded
with the first (the conventions of the released model's CUDA ops). On a CUDA
tensor the SA layers run the `fps` and `ball_query` kernels and the FP layers
`nn_topk`; on a CPU tensor their plain versions.

BatchNorm is written out, not `nn.BatchNorm1d`: `bn_mode="running"`
normalises by the stored running statistics (the frozen extractor);
`bn_mode="batch"` by the moments of the current batch over all non-channel
axes, with the BIASED variance, and appends each layer's (mean, var) to
`stats_out` in `bn_paths` order. `apply_bn_ema` writes that same biased
variance into the running statistics, as the JAX package does (torch's own
BatchNorm would store the unbiased one), so a trained file gives the same
features in either package.

Checkpoints: the native pickle `reart_tpu_corr_v1` ({"format", "params"}, the
JAX package's parameter tree with numpy leaves, `w` stored (in, out)) is read
and written so that either package loads the other's file; the released
torch tar (`state_dict` with Conv2d/Conv1d + BatchNorm keys) is read and
written too.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from reart_tpu_torch import resolve_device
from reart_tpu_torch.ops.interpolate import three_interpolate
from reart_tpu_torch.ops.sampling import (
    ball_query,
    farthest_point_sample,
    index_points,
)

BN_EPS = 1e-5

# (npoint, radii, nsamples, in_channel, mlps)
SA1 = (512, (0.05, 0.1, 0.2), (32, 64, 128), 3,
       ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA2 = (128, (0.2, 0.4), (64, 128), 128 + 128 + 64,
       ((128, 128, 256), (128, 196, 256)))
SA3_MLP = (256, 512, 1024)
SA3_IN = 512 + 3
FP3 = (1536, (256, 256))
FP2 = (576, (256, 128))
FP1 = (134, (128, 128))

CORR_NATIVE_FORMAT = "reart_tpu_corr_v1"


class ConvBN(nn.Module):
    """A 1x1 convolution (a dense layer over the last axis), BatchNorm and
    ReLU. `weight` is (out, in), torch's layout."""

    def __init__(self, c_in: int, c_out: int, *, generator=None, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty((c_out, c_in), **kw))
        self.bias = nn.Parameter(torch.empty((c_out,), **kw))
        self.bn_weight = nn.Parameter(torch.ones((c_out,), **kw))
        self.bn_bias = nn.Parameter(torch.zeros((c_out,), **kw))
        self.register_buffer("running_mean", torch.zeros((c_out,), **kw))
        self.register_buffer("running_var", torch.ones((c_out,), **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """torch's Conv(k=1) defaults, U(-1/sqrt(c_in), 1/sqrt(c_in)) for
        the weight and the bias, drawn on the generator's device."""
        src = generator.device if generator is not None else "cpu"
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for p in (self.weight, self.bias):
            p.copy_(torch.empty(p.shape, device=src).uniform_(
                -bound, bound, generator=generator))

    def forward(self, x, relu: bool = True, bn_mode: str = "running",
                stats_out: list | None = None):
        """x (..., c_in) -> relu(bn(x @ w.T + b))."""
        y = F.linear(x, self.weight) + self.bias
        if bn_mode == "batch":
            axes = tuple(range(y.dim() - 1))
            mean = torch.mean(y, dim=axes)
            var = torch.var(y, dim=axes, unbiased=False)
            if stats_out is not None:
                stats_out.append((mean, var))
        elif bn_mode == "running":
            mean, var = self.running_mean, self.running_var
        else:
            raise ValueError(f"unknown bn_mode {bn_mode!r}")
        y = (y - mean) / torch.sqrt(var + BN_EPS)
        y = y * self.bn_weight + self.bn_bias
        return F.relu(y) if relu else y


def _stack(c_in, channels, generator, device):
    layers = []
    for c_out in channels:
        layers.append(ConvBN(c_in, c_out, generator=generator, device=device))
        c_in = c_out
    return nn.ModuleList(layers)


def _sa_msg(blocks, npoint, radii, nsamples, xyz, points, bn_mode, stats_out):
    """Multi-scale-grouping set abstraction: xyz (B, N, 3), points (B, N, D)
    -> (new_xyz (B, S, 3), feats (B, S, sum D')). Grouped features first,
    centred coordinates after."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)                         # (B, S, 3)
    outs = []
    for block, radius, k in zip(blocks, radii, nsamples):
        gidx = ball_query(radius, k, xyz, new_xyz)               # (B, S, K)
        gxyz = index_points(xyz, gidx) - new_xyz[:, :, None, :]
        feat = torch.cat([index_points(points, gidx), gxyz], dim=-1)
        for layer in block:
            feat = layer(feat, bn_mode=bn_mode, stats_out=stats_out)
        outs.append(torch.amax(feat, dim=2))                     # (B, S, D')
    return new_xyz, torch.cat(outs, dim=-1)


def _sa_group_all(block, xyz, points, bn_mode, stats_out):
    """Global set abstraction: raw coordinates first, features after."""
    feat = torch.cat([xyz, points], dim=-1)[:, None]       # (B, 1, N, 3 + D)
    for layer in block:
        feat = layer(feat, bn_mode=bn_mode, stats_out=stats_out)
    new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype,
                          device=xyz.device)
    return new_xyz, torch.amax(feat, dim=2)                      # (B, 1, D')


def _fp(block, xyz1, xyz2, points1, points2, bn_mode, stats_out):
    """Feature propagation: `three_interpolate` (S > 1) or a broadcast
    (S == 1), the skip features in front, then the MLP."""
    b, n, _ = xyz1.shape
    if xyz2.shape[1] == 1:
        interp = points2.expand(b, n, points2.shape[-1])
    else:
        interp = three_interpolate(xyz1, xyz2, points2)
    feat = interp if points1 is None else torch.cat([points1, interp], -1)
    for layer in block:
        feat = layer(feat, bn_mode=bn_mode, stats_out=stats_out)
    return feat


class PointNet2Msg2(nn.Module):
    """The correspondence backbone, built on the card unless `device` names
    another device. Weights are drawn from `generator` (torch's Conv
    defaults); real use loads a checkpoint (`load_corr_model`)."""

    def __init__(self, out_dim: int = 64, *, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        self.sa1 = nn.ModuleList(
            _stack(SA1[3] + 3, m, **kw) for m in SA1[4])
        self.sa2 = nn.ModuleList(
            _stack(SA2[3] + 3, m, **kw) for m in SA2[4])
        self.sa3 = _stack(SA3_IN, SA3_MLP, **kw)
        self.fp3 = _stack(FP3[0], FP3[1], **kw)
        self.fp2 = _stack(FP2[0], FP2[1], **kw)
        self.fp1 = _stack(FP1[0], FP1[1], **kw)
        self.head = ConvBN(128, out_dim, **kw)

    @property
    def out_dim(self) -> int:
        return self.head.weight.shape[0]

    def forward(self, xyz: torch.Tensor, bn_mode: str = "running",
                stats_out: list | None = None) -> torch.Tensor:
        """xyz (B, N, 3) -> per-point features (B, N, out_dim). "running"
        is the frozen inference path; "batch" the training mode, collecting
        per-layer moments into `stats_out` in `bn_paths` order."""
        args = (bn_mode, stats_out)
        l1_xyz, l1_points = _sa_msg(self.sa1, SA1[0], SA1[1], SA1[2], xyz,
                                    xyz, *args)
        l2_xyz, l2_points = _sa_msg(self.sa2, SA2[0], SA2[1], SA2[2],
                                    l1_xyz, l1_points, *args)
        l3_xyz, l3_points = _sa_group_all(self.sa3, l2_xyz, l2_points, *args)
        l2_points = _fp(self.fp3, l2_xyz, l3_xyz, l2_points, l3_points, *args)
        l1_points = _fp(self.fp2, l1_xyz, l2_xyz, l1_points, l2_points, *args)
        l0_points = _fp(self.fp1, xyz, l1_xyz, torch.cat([xyz, xyz], -1),
                        l1_points, *args)
        return self.head(l0_points, bn_mode=bn_mode, stats_out=stats_out)


def bn_paths() -> list:
    """Key paths of every conv+BN layer in forward order, the order in which
    `stats_out` fills: ("sa1", block, layer), ..., ("sa3", layer), ...,
    ("head",). The same list as the JAX package's `bn_paths`."""
    paths = []
    for name, spec in (("sa1", SA1), ("sa2", SA2)):
        for bi, mlp in enumerate(spec[4]):
            paths.extend((name, bi, li) for li in range(len(mlp)))
    for name, n in (("sa3", len(SA3_MLP)), ("fp3", len(FP3[1])),
                    ("fp2", len(FP2[1])), ("fp1", len(FP1[1]))):
        paths.extend((name, li) for li in range(n))
    paths.append(("head",))
    return paths


def layer_at(model: PointNet2Msg2, path) -> ConvBN:
    """The ConvBN of a `bn_paths` entry."""
    node = getattr(model, path[0])
    for p in path[1:]:
        node = node[p]
    return node


@torch.no_grad()
def apply_bn_ema(model: PointNet2Msg2, stats, momentum: float) -> None:
    """running = (1 - m) * running + m * batch, in place, for the moments a
    "batch" forward collected (biased variance, as collected)."""
    paths = bn_paths()
    if len(paths) != len(stats):
        raise ValueError(f"{len(stats)} moments for {len(paths)} layers")
    for path, (mean, var) in zip(paths, stats):
        layer = layer_at(model, path)
        layer.running_mean.mul_(1 - momentum).add_(
            momentum * mean.detach().to(torch.float32))
        layer.running_var.mul_(1 - momentum).add_(
            momentum * var.detach().to(torch.float32))


# ---------------------------------------------------------------------------
# the JAX package's parameter tree, numpy leaves
# ---------------------------------------------------------------------------

def _layer_to_numpy(layer: ConvBN) -> dict:
    def a(t):
        return t.detach().cpu().numpy().copy()

    return {"w": a(layer.weight).T.copy(), "b": a(layer.bias),
            "bn_w": a(layer.bn_weight), "bn_b": a(layer.bn_bias),
            "bn_mean": a(layer.running_mean), "bn_var": a(layer.running_var)}


def params_to_numpy(model: PointNet2Msg2) -> dict:
    """The JAX parameter tree of the module: {"sa1": [[layer, ...], ...],
    "sa2": ..., "sa3": [layer, ...], "fp3", "fp2", "fp1", "head": layer},
    each layer {"w" (in, out), "b", "bn_w", "bn_b", "bn_mean", "bn_var"}."""
    tree = {name: [[_layer_to_numpy(l) for l in block]
                   for block in getattr(model, name)]
            for name in ("sa1", "sa2")}
    for name in ("sa3", "fp3", "fp2", "fp1"):
        tree[name] = [_layer_to_numpy(l) for l in getattr(model, name)]
    tree["head"] = _layer_to_numpy(model.head)
    return tree


@torch.no_grad()
def _load_layer(layer: ConvBN, leaf: dict, where: str) -> None:
    values = {"weight": np.asarray(leaf["w"], np.float32).T,
              "bias": leaf["b"], "bn_weight": leaf["bn_w"],
              "bn_bias": leaf["bn_b"], "running_mean": leaf["bn_mean"],
              "running_var": leaf["bn_var"]}
    for name, value in values.items():
        target = getattr(layer, name)
        value = np.array(value, dtype=np.float32)  # a writable copy
        if value.shape != tuple(target.shape):
            raise ValueError(f"{where}.{name}: expected "
                             f"{tuple(target.shape)}, got {value.shape}")
        target.copy_(torch.from_numpy(value))


def params_from_numpy(tree, device=None) -> PointNet2Msg2:
    """A PointNet2Msg2 on `device` (the card when None) holding the values
    of a JAX parameter tree (numpy leaves, or anything np.asarray takes)."""
    out_dim = np.asarray(tree["head"]["w"]).shape[1]
    model = PointNet2Msg2(out_dim, device=device)
    for path in bn_paths():
        leaf = tree
        for p in path:
            leaf = leaf[p]
        _load_layer(layer_at(model, path), leaf, ".".join(map(str, path)))
    return model


# ---------------------------------------------------------------------------
# the released checkpoint's state_dict
# ---------------------------------------------------------------------------

def _torch_keys():
    """(bn_paths entry, conv key, bn key, conv rank) for every layer: SA
    layers are Conv2d, FP layers and the head Conv1d."""
    keys = []
    for name, spec in (("sa1", SA1), ("sa2", SA2)):
        for i, mlp in enumerate(spec[4]):
            for j in range(len(mlp)):
                keys.append(((name, i, j), f"{name}.conv_blocks.{i}.{j}",
                             f"{name}.bn_blocks.{i}.{j}", 4))
    for name, n, rank in (("sa3", len(SA3_MLP), 4), ("fp3", len(FP3[1]), 3),
                          ("fp2", len(FP2[1]), 3), ("fp1", len(FP1[1]), 3)):
        for j in range(n):
            keys.append(((name, j), f"{name}.mlp_convs.{j}",
                         f"{name}.mlp_bns.{j}", rank))
    keys.append((("head",), "conv1", "bn1", 3))
    return keys


def load_torch_state_dict(state_dict, device=None) -> PointNet2Msg2:
    """The released corr-model state_dict (tensors or numpy; the prefixes
    'net.' / 'module.' are stripped) -> a PointNet2Msg2 on `device`."""
    sd = {}
    for k, v in state_dict.items():
        k = k.replace("net.", "").replace("module.", "")
        sd[k] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                 else np.asarray(v))
    out_dim = sd["conv1.weight"].shape[0]
    model = PointNet2Msg2(out_dim, device=device)
    for path, conv, bn, _ in _torch_keys():
        w = sd[f"{conv}.weight"]
        leaf = {"w": w.reshape(w.shape[0], w.shape[1]).T,
                "b": sd[f"{conv}.bias"], "bn_w": sd[f"{bn}.weight"],
                "bn_b": sd[f"{bn}.bias"], "bn_mean": sd[f"{bn}.running_mean"],
                "bn_var": sd[f"{bn}.running_var"]}
        _load_layer(layer_at(model, path), leaf, conv)
    return model


def export_torch_state_dict(model: PointNet2Msg2) -> dict:
    """Inverse of load_torch_state_dict: numpy arrays under the released
    model's keys, conv weights (out, in, 1[, 1])."""
    sd = {}
    for path, conv, bn, rank in _torch_keys():
        leaf = _layer_to_numpy(layer_at(model, path))
        w = leaf["w"].T
        sd[f"{conv}.weight"] = w.reshape(w.shape + (1,) * (rank - 2)).copy()
        sd[f"{conv}.bias"] = leaf["b"]
        sd[f"{bn}.weight"] = leaf["bn_w"]
        sd[f"{bn}.bias"] = leaf["bn_b"]
        sd[f"{bn}.running_mean"] = leaf["bn_mean"]
        sd[f"{bn}.running_var"] = leaf["bn_var"]
        sd[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def save_corr_model_torch(path: str, model: PointNet2Msg2) -> None:
    """Save in the released checkpoint's torch format."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(model).items()}
    torch.save({"state_dict": sd}, path)


def save_corr_model(path: str, model: PointNet2Msg2) -> None:
    """Save natively: the pickle the JAX package's `load_corr_model` reads."""
    with open(path, "wb") as f:
        pickle.dump({"format": CORR_NATIVE_FORMAT,
                     "params": params_to_numpy(model)}, f)


def load_corr_model(path: str, device=None) -> PointNet2Msg2:
    """Load a correspondence checkpoint on `device` (the card when None):
    the native pickle of either package, or the released torch tar (a zip
    archive, which `torch.load` reads)."""
    with open(path, "rb") as f:
        if f.read(2) != b"PK":
            f.seek(0)
            try:
                obj = pickle.load(f)
            except (pickle.UnpicklingError, AttributeError, ImportError,
                    EOFError, ValueError):
                obj = None  # a torch.save stream of the legacy format
            if (isinstance(obj, dict)
                    and obj.get("format") == CORR_NATIVE_FORMAT):
                return params_from_numpy(obj["params"], device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return load_torch_state_dict(sd, device)
