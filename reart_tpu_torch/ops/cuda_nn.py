"""Neighbour kernels (csrc/nn1_bidir_coords.cu, csrc/blend3.cu) with their
plain PyTorch versions.

Counterpart of reart_tpu/ops/pallas_nn.py for the two kernels on the
relaxation fit's path:

  * `nn1_bidir_coords`: fused bidirectional 1-NN with the winners' coords
    (Pallas `nn1_bidir_coords_pallas`), the Chamfer forward and the coords
    its gradient needs;
  * `blend3`: 3-NN inverse-distance flow blend plus the two inputs of the
    flow validity mask (Pallas `blend3_pallas`).

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); `<wrapper>.launches` counts kernel
launches. Each plain version computes the same distance formula as its
kernel, in the same order of additions, so indices agree exactly.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops import _build


# the kernels put the batch on gridDim.y
MAX_BATCH = 65535


def _check_clouds(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3:
        raise ValueError(f"{name}: expected (B, N, 3) and (B, M, 3), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] or 0 in a.shape or 0 in b.shape:
        raise ValueError(f"{name}: batch sizes differ or a cloud is empty: "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] > MAX_BATCH:
        raise ValueError(f"{name}: batch {a.shape[0]} > {MAX_BATCH}")


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, M, C), idx (B, N) -> (B, N, C)."""
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def ksmallest(d: torch.Tensor, k: int):
    """k smallest along the last axis by k masked-argmin passes: ascending
    values, equal values in ascending index (torch.topk promises no tie
    order). Returns (values (..., k), indices (..., k))."""
    v = d.clone()
    vals, idxs = [], []
    for j in range(k):
        i = torch.argmin(v, dim=-1, keepdim=True)
        vals.append(torch.gather(v, -1, i))
        idxs.append(i)
        if j < k - 1:
            v.scatter_(-1, i, float("inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


# ---------------------------------------------------------------------------
# nn1_bidir_coords
# ---------------------------------------------------------------------------

def _sqdist_diff2(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(B, N, M) channel-wise diff^2 distances, (dx^2 + dy^2) + dz^2."""
    d = None
    for c in range(3):
        diff = src[..., c][:, :, None] - tgt[..., c][:, None, :]
        d = diff * diff if d is None else d + diff * diff
    return d


def nn1_bidir_coords_plain(src: torch.Tensor, tgt: torch.Tensor):
    """src (B, N, 3), tgt (B, M, 3) -> (fwd_sqdist (B, N), fwd_idx,
    fwd_coords (B, N, 3), bwd_sqdist (B, M), bwd_idx, bwd_coords (B, M, 3)).
    Indices are int64; ties go to the lowest index both ways."""
    d = _sqdist_diff2(src, tgt)
    fi = torch.argmin(d, dim=2)
    fd = torch.gather(d, 2, fi[..., None])[..., 0]
    bi = torch.argmin(d, dim=1)
    bd = torch.gather(d, 1, bi[:, None, :])[:, 0, :]
    return fd, fi, _gather_rows(tgt, fi), bd, bi, _gather_rows(src, bi)


def nn1_bidir_coords(src: torch.Tensor, tgt: torch.Tensor):
    """Fused bidirectional 1-NN with coords; see nn1_bidir_coords_plain."""
    name = "nn1_bidir_coords"
    _check_clouds(name, src, tgt)
    if _build.is_cpu(name, src):
        return nn1_bidir_coords_plain(src, tgt)
    _build.require_cuda(name, src, tgt, dtype=torch.float32)
    b, n, m = src.shape[0], src.shape[1], tgt.shape[1]
    f32 = dict(dtype=torch.float32, device=src.device)
    i64 = dict(dtype=torch.int64, device=src.device)
    fd, fi, fc = (torch.empty((b, n), **f32), torch.empty((b, n), **i64),
                  torch.empty((b, n, 3), **f32))
    bd, bi, bc = (torch.empty((b, m), **f32), torch.empty((b, m), **i64),
                  torch.empty((b, m, 3), **f32))
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.reart_nn1_bidir_coords(
            src.data_ptr(), tgt.data_ptr(), b, n, m,
            fd.data_ptr(), fi.data_ptr(), fc.data_ptr(),
            bd.data_ptr(), bi.data_ptr(), bc.data_ptr(),
            _build.stream_of(src))
    _build.check_launch(name, err)
    nn1_bidir_coords.launches += 1
    return fd, fi, fc, bd, bi, bc


nn1_bidir_coords.launches = 0


# ---------------------------------------------------------------------------
# blend3
# ---------------------------------------------------------------------------

def _sqnorm(p: torch.Tensor) -> torch.Tensor:
    """(x^2 + y^2) + z^2 over the last axis, in the kernels' order."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
            + p[..., 2] * p[..., 2])


def blend3_plain(query: torch.Tensor, ref: torch.Tensor, flow: torch.Tensor):
    """query (B, N, 3), ref/flow (B, M >= 3, 3) -> (blended (B, N, 3),
    min_dist (B, N), flow_sqnorm_max (B, N)); see csrc/blend3.cu."""
    q2 = _sqnorm(query)[:, :, None]
    r2 = _sqnorm(ref)[:, None, :]
    cross = None
    for c in range(3):
        t = query[..., c][:, :, None] * ref[..., c][:, None, :]
        cross = t if cross is None else cross + t
    d = torch.clamp_min((q2 + r2) - 2.0 * cross, 0.0)
    dk, ik = ksmallest(d, 3)                                  # (B, N, 3)
    dist = torch.clamp_min(torch.sqrt(torch.clamp_min(dk, 0.0)), 1e-10)
    w = 1.0 / dist
    wsum = (w[..., 0] + w[..., 1]) + w[..., 2]
    f = [_gather_rows(flow, ik[..., j]) for j in range(3)]    # 3 x (B, N, 3)
    blended = (w[..., 0:1] * f[0] + w[..., 1:2] * f[1]) + w[..., 2:3] * f[2]
    fs = [_sqnorm(fj) for fj in f]
    flow_d = torch.maximum(torch.maximum(fs[0], fs[1]), fs[2])
    return blended / wsum[..., None], dist[..., 0], flow_d


def blend3(query: torch.Tensor, ref: torch.Tensor, flow: torch.Tensor):
    """Fused 3-NN flow blend; see blend3_plain. Needs >= 3 anchors."""
    name = "blend3"
    _check_clouds(name, query, ref)
    if flow.shape != ref.shape:
        raise ValueError(f"{name}: flow {tuple(flow.shape)} must match ref "
                         f"{tuple(ref.shape)}")
    if ref.shape[1] < 3:
        raise ValueError(f"{name}: needs at least 3 anchors, got "
                         f"{ref.shape[1]}")
    if _build.is_cpu(name, query):
        return blend3_plain(query, ref, flow)
    _build.require_cuda(name, query, ref, flow, dtype=torch.float32)
    b, n, m = query.shape[0], query.shape[1], ref.shape[1]
    f32 = dict(dtype=torch.float32, device=query.device)
    out = torch.empty((b, n, 3), **f32)
    min_d, flow_d = torch.empty((b, n), **f32), torch.empty((b, n), **f32)
    lib = _build.load_library()
    with torch.cuda.device(query.device):
        err = lib.reart_blend3(
            query.data_ptr(), ref.data_ptr(), flow.data_ptr(), b, n, m,
            out.data_ptr(), min_d.data_ptr(), flow_d.data_ptr(),
            _build.stream_of(query))
    _build.check_launch(name, err)
    blend3.launches += 1
    return out, min_d, flow_d


blend3.launches = 0
