"""Neighbour kernels (csrc/nn1_bidir_coords.cu, blend3.cu, nn_topk.cu,
nn1_coords.cu, nn_bidir.cu) with their plain PyTorch versions.

Counterpart of reart_tpu/ops/pallas_nn.py:

  * `nn1_bidir_coords`: fused bidirectional 1-NN with the winners' coords
    (Pallas `nn1_bidir_coords_pallas`), the Chamfer forward and the coords
    its gradient needs;
  * `blend3`: 3-NN inverse-distance flow blend plus the two inputs of the
    flow validity mask (Pallas `blend3_pallas`);
  * `nn_topk`: batched k-NN, ascending squared distances and indices
    (Pallas `nn_topk_pallas`): label transfer, metrics, seg refinement;
  * `nn1_coords`: single-direction 1-NN with the winner's coords (Pallas
    `nn1_coords_pallas`), behind the single-direction Chamfer;
  * `nn_bidir`: bidirectional 1-NN without coords (Pallas
    `nn_bidir_pallas`): both directions of the Chamfer metric in one launch.

The three scans of the second group share csrc/nn_scan.cuh.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); `<wrapper>.launches` counts kernel
launches. Each plain version computes the same distance formula as its
kernel, in the same order of additions, so indices agree exactly.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops import _build


# nn1_bidir_coords and blend3 put the batch on gridDim.y
MAX_BATCH = 65535
# nn_topk, nn1_coords and nn_bidir fold the batch into gridDim.x
MAX_BLOCKS = 2 ** 31 - 1
# largest k of nn_topk: the kernel keeps its running top-k in registers, in
# instances for k = 1, 3 and 8 (the largest k the package asks for)
MAX_K = 8
# float32 entries of one distance-matrix chunk of the plain versions
_PLAIN_CHUNK = 1 << 26


def _check_clouds(name: str, a: torch.Tensor, b: torch.Tensor,
                  max_batch: int = MAX_BATCH) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3:
        raise ValueError(f"{name}: expected (B, N, 3) and (B, M, 3), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] or 0 in a.shape or 0 in b.shape:
        raise ValueError(f"{name}: batch sizes differ or a cloud is empty: "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] > max_batch:
        raise ValueError(f"{name}: batch {a.shape[0]} > {max_batch}")


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


# ---------------------------------------------------------------------------
# nn_topk
# ---------------------------------------------------------------------------

def _batch_chunks(b: int, n: int, m: int):
    """Batch ranges whose (chunk, N, M) distance matrix stays bounded."""
    step = max(1, _PLAIN_CHUNK // max(1, n * m))
    return [(b0, min(b, b0 + step)) for b0 in range(0, b, step)]


def _flatten_query_ref(name: str, query: torch.Tensor, ref: torch.Tensor):
    """query (..., N, 3), ref (..., M, 3) -> (query (B, N, 3), ref (Br, M, 3),
    ref_div, batch shape) with B == Br * ref_div: batch element b reads
    reference cloud b // ref_div. A reference whose trailing batch dims are
    broadcast is kept as it is; any other broadcast is materialised."""
    if (query.dim() < 2 or ref.dim() < 2 or query.shape[-1] != 3
            or ref.shape[-1] != 3 or ref.dim() > query.dim()):
        raise ValueError(f"{name}: expected (..., N, 3) and (..., M, 3), got "
                         f"{tuple(query.shape)} and {tuple(ref.shape)}")
    if 0 in query.shape or 0 in ref.shape:
        raise ValueError(f"{name}: a cloud is empty: {tuple(query.shape)} "
                         f"and {tuple(ref.shape)}")
    batch = tuple(query.shape[:-2])
    rb = (1,) * (len(batch) - (ref.dim() - 2)) + tuple(ref.shape[:-2])
    j = len(batch)
    while j > 0 and rb[j - 1] == 1:
        j -= 1
    if rb[:j] != batch[:j]:  # a broadcast in a leading or middle dim
        ref = ref.expand(batch + tuple(ref.shape[-2:]))
        j = len(batch)
    ref_div = 1
    for s in batch[j:]:
        ref_div *= s
    q = query.reshape((-1,) + tuple(query.shape[-2:]))
    r = ref.reshape((-1,) + tuple(ref.shape[-2:]))
    return q, r, ref_div, batch


def nn_topk_plain(query: torch.Tensor, ref: torch.Tensor, k: int,
                  ref_div: int = 1):
    """query (B, N, 3), ref (B // ref_div, M, 3) -> (sqdist (B, N, k)
    ascending, idx (B, N, k) int64); equal distances in ascending index;
    with M < k the missing slots hold (+inf, 0). Chunked over the batch: the
    (B, N, M) matrix of a large call does not fit in memory."""
    b, n, m = query.shape[0], query.shape[1], ref.shape[1]
    ds, idxs = [], []
    for b0, b1 in _batch_chunks(b, n, m):
        rows = torch.arange(b0, b1, device=ref.device) // ref_div
        d, i = ksmallest(_sqdist_diff2(query[b0:b1], ref[rows]), k)
        ds.append(d)
        idxs.append(i)
    return torch.cat(ds), torch.cat(idxs)


def nn_topk(query: torch.Tensor, ref: torch.Tensor, k: int):
    """Batched k-NN: query (..., N, 3), ref (..., M, 3) -> (sqdist
    (..., N, k) ascending, idx (..., N, k) int64). The reference's batch dims
    broadcast against the query's; see nn_topk_plain. Not differentiable:
    consumers recompute distances from gathered points."""
    name = "nn_topk"
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k must be in [1, {MAX_K}], got {k}")
    q, r, ref_div, batch = _flatten_query_ref(name, query.detach(),
                                              ref.detach())
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    if _build.is_cpu(name, q):
        d, i = nn_topk_plain(q, r, k, ref_div)
    else:
        q, r = q.contiguous(), r.contiguous()
        _build.require_cuda(name, q, r, dtype=torch.float32)
        if b * (-(-n // 32)) > MAX_BLOCKS:
            raise ValueError(f"{name}: batch {b} x {n} queries is past the "
                             f"grid limit")
        d = torch.empty((b, n, k), dtype=torch.float32, device=q.device)
        i = torch.empty((b, n, k), dtype=torch.int64, device=q.device)
        lib = _build.load_library()
        with torch.cuda.device(q.device):
            err = lib.reart_nn_topk(q.data_ptr(), r.data_ptr(), b, n, m,
                                    ref_div, k, d.data_ptr(), i.data_ptr(),
                                    _build.stream_of(q))
        _build.check_launch(name, err)
        nn_topk.launches += 1
    return d.reshape(batch + (n, k)), i.reshape(batch + (n, k))


nn_topk.launches = 0


# ---------------------------------------------------------------------------
# nn1_coords
# ---------------------------------------------------------------------------

def nn1_coords_plain(query: torch.Tensor, ref: torch.Tensor):
    """query (B, N, 3), ref (B, M, 3) -> (sqdist (B, N), idx (B, N) int64,
    coords (B, N, 3) of the winners); ties go to the lowest index."""
    ds, idxs = [], []
    for b0, b1 in _batch_chunks(query.shape[0], query.shape[1], ref.shape[1]):
        d = _sqdist_diff2(query[b0:b1], ref[b0:b1])
        i = torch.argmin(d, dim=2)
        ds.append(torch.gather(d, 2, i[..., None])[..., 0])
        idxs.append(i)
    d, i = torch.cat(ds), torch.cat(idxs)
    return d, i, _gather_rows(ref, i)


def nn1_coords(query: torch.Tensor, ref: torch.Tensor):
    """1-NN with the winner's coords; see nn1_coords_plain."""
    name = "nn1_coords"
    _check_clouds(name, query, ref, max_batch=MAX_BLOCKS)
    if _build.is_cpu(name, query):
        return nn1_coords_plain(query, ref)
    _build.require_cuda(name, query, ref, dtype=torch.float32)
    b, n, m = query.shape[0], query.shape[1], ref.shape[1]
    if b * (-(-n // 32)) > MAX_BLOCKS:
        raise ValueError(f"{name}: batch {b} x {n} queries is past the grid "
                         f"limit")
    d = torch.empty((b, n), dtype=torch.float32, device=query.device)
    i = torch.empty((b, n), dtype=torch.int64, device=query.device)
    c = torch.empty((b, n, 3), dtype=torch.float32, device=query.device)
    lib = _build.load_library()
    with torch.cuda.device(query.device):
        err = lib.reart_nn1_coords(query.data_ptr(), ref.data_ptr(), b, n, m,
                                   d.data_ptr(), i.data_ptr(), c.data_ptr(),
                                   _build.stream_of(query))
    _build.check_launch(name, err)
    nn1_coords.launches += 1
    return d, i, c


nn1_coords.launches = 0


# ---------------------------------------------------------------------------
# nn_bidir
# ---------------------------------------------------------------------------

def nn_bidir_plain(src: torch.Tensor, tgt: torch.Tensor):
    """src (B, N, 3), tgt (B, M, 3) -> (fwd_sqdist (B, N), fwd_idx,
    bwd_sqdist (B, M), bwd_idx); int64 indices, ties to the lowest index."""
    outs = [[], [], [], []]
    for b0, b1 in _batch_chunks(src.shape[0], src.shape[1], tgt.shape[1]):
        d = _sqdist_diff2(src[b0:b1], tgt[b0:b1])
        fi = torch.argmin(d, dim=2)
        bi = torch.argmin(d, dim=1)
        outs[0].append(torch.gather(d, 2, fi[..., None])[..., 0])
        outs[1].append(fi)
        outs[2].append(torch.gather(d, 1, bi[:, None, :])[:, 0, :])
        outs[3].append(bi)
    return tuple(torch.cat(o) for o in outs)


def nn_bidir(src: torch.Tensor, tgt: torch.Tensor):
    """Bidirectional 1-NN without coords; see nn_bidir_plain."""
    name = "nn_bidir"
    _check_clouds(name, src, tgt, max_batch=MAX_BLOCKS)
    if _build.is_cpu(name, src):
        return nn_bidir_plain(src, tgt)
    _build.require_cuda(name, src, tgt, dtype=torch.float32)
    b, n, m = src.shape[0], src.shape[1], tgt.shape[1]
    if b * (-(-max(n, m) // 32)) > MAX_BLOCKS:
        raise ValueError(f"{name}: batch {b} x {max(n, m)} queries is past "
                         f"the grid limit")
    f32 = dict(dtype=torch.float32, device=src.device)
    i64 = dict(dtype=torch.int64, device=src.device)
    fd, fi = torch.empty((b, n), **f32), torch.empty((b, n), **i64)
    bd, bi = torch.empty((b, m), **f32), torch.empty((b, m), **i64)
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.reart_nn_bidir(src.data_ptr(), tgt.data_ptr(), b, n, m,
                                 fd.data_ptr(), fi.data_ptr(), bd.data_ptr(),
                                 bi.data_ptr(), _build.stream_of(src))
    _build.check_launch(name, err)
    nn_bidir.launches += 1
    return fd, fi, bd, bi


nn_bidir.launches = 0
