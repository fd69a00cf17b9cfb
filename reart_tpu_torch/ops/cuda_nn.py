"""Neighbour kernels (csrc/nn1_bidir_coords.cu, blend3.cu, nn_topk.cu,
nn1_coords.cu, nn_bidir.cu, ball_query.cu) with their plain PyTorch versions.

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
    `nn_bidir_pallas`): both directions of the Chamfer metric in one launch;
  * `ball_query`: the first K in-radius points of every centroid, in point
    order (Pallas `ball_query_pallas`): the grouping of the PointNet++
    set-abstraction layers.

`nn1_bidir_coords`, `blend3`, `nn_topk` and `nn_bidir` split their scans
across threads and blocks and merge the partial winners in (distance,
index) order (csrc/nn_split.cuh); `nn1_coords` walks small cloud pairs in
groups of lanes and larger ones through `nn_topk`'s k = 1 kernel.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); `<wrapper>.launches` counts kernel
launches. Each plain version computes the same distance formula as its
kernel, in the same order of additions, so indices agree exactly.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops import _build


# nn1_bidir_coords and blend3 put the batch on gridDim.z and gridDim.y
MAX_BATCH = 65535
# nn1_bidir_coords: the (src rows, tgt columns) tile of one block; the
# column tiles go on gridDim.y
NN1_BIDIR_TILE = (128, 512)
# blend3: a block of 128 threads, 2 queries each, holds BLEND3_QUERIES // S
# queries and cuts the anchors into S slices (S a power of two up to
# BLEND3_MAX_SLICES) of at least BLEND3_MIN_SLICE anchors
BLEND3_QUERIES = 256
BLEND3_MAX_SLICES = 16
BLEND3_MIN_SLICE = 64
# blend3's threshold pass reads every BLEND3_SAMPLE-th anchor of a slice
BLEND3_SAMPLE = 4
# nn_topk, nn1_coords, nn_bidir and ball_query fold the batch into gridDim.x
MAX_BLOCKS = 2 ** 31 - 1
# nn_bidir: a unit is a row block of W warps (a power of two up to
# NN_BIDIR_MAX_WARPS) x NN_BIDIR_RT src rows (kRT of csrc/nn_bidir.cu)
# against a chunk of 32 L tgt columns (L up to NN_BIDIR_MAX_RUN); the grid
# is the blocks an SM holds at once (NN_BIDIR_WARPS_PER_SM warps,
# registers; at most NN_BIDIR_BLOCKS_PER_SM blocks, shared memory) on every
# SM, each block an equal run of units; see nn_bidir_plan
NN_BIDIR_RT = 16
NN_BIDIR_MAX_WARPS = 8
NN_BIDIR_MAX_RUN = 16
NN_BIDIR_WARPS_PER_SM = 16
NN_BIDIR_BLOCKS_PER_SM = 6
# nn1_coords: clouds of at most NN1C_MAX_PACKED points each go NN1C_LANES
# lanes a pair (the smallest that holds both), NN1C_WARPS warps a block
# (1 to NN1C_MAX_WARPS are within 0.1 us of each other at the graph stage's
# shapes on an H100; 3 puts P = 20's 400 pairs in 134 blocks, a block on
# each of 132 SMs); larger ones through nn_topk's k = 1 kernel; see
# nn1_coords_plan
NN1C_MAX_PACKED = 32
NN1C_LANES = (8, 16, 32)
NN1C_WARPS = 3
NN1C_MAX_WARPS = 8
# largest k of nn_topk: the kernel keeps its running top-k in registers, in
# instances for k = 1, 3 and 8 (the largest k the package asks for)
MAX_K = 8
# nn_topk: a block of NN_THREADS threads, each with 1 or NN_QPT queries,
# cuts the reference into S slices (S a power of two up to NN_MAX_SLICES)
# of at least NN_MIN_SLICE points, while the grid holds fewer than
# NN_BLOCKS_PER_SM blocks an SM (for k = 1, k > 1); see nn_topk_plan
NN_THREADS = 128
NN_QPT = _build.DEFINES["REART_NN_QPT"]
NN_MAX_SLICES = 16
NN_MIN_SLICE = 32
NN_BLOCKS_PER_SM = (8, 3)
# ball_query: a warp per centroid, BQ_MAX_WARPS centroids a block, fewer
# (down to BQ_MIN_WARPS) where the grid would not fill the card
BQ_MAX_WARPS = 16
BQ_MIN_WARPS = 4
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
    if -(-m // NN1_BIDIR_TILE[1]) > MAX_BATCH:
        raise ValueError(f"{name}: {m} target points is past the grid limit")
    f32 = dict(dtype=torch.float32, device=src.device)
    i64 = dict(dtype=torch.int64, device=src.device)
    fd, fi, fc = (torch.empty((b, n), **f32), torch.empty((b, n), **i64),
                  torch.empty((b, n, 3), **f32))
    bd, bi, bc = (torch.empty((b, m), **f32), torch.empty((b, m), **i64),
                  torch.empty((b, m, 3), **f32))
    # the (distance, index) keys of the merge; the kernel sets them
    fkey, bkey = torch.empty((b, n), **i64), torch.empty((b, m), **i64)
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.reart_nn1_bidir_coords(
            src.data_ptr(), tgt.data_ptr(), b, n, m,
            fd.data_ptr(), fi.data_ptr(), fc.data_ptr(),
            bd.data_ptr(), bi.data_ptr(), bc.data_ptr(),
            fkey.data_ptr(), bkey.data_ptr(), _build.stream_of(src))
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


def blend3_sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, N, M) distances of blend3: (|q|^2 + |r|^2) - 2 q.r clamped at 0,
    q.r summed (x + y) + z."""
    q2 = _sqnorm(query)[:, :, None]
    r2 = _sqnorm(ref)[:, None, :]
    cross = None
    for c in range(3):
        t = query[..., c][:, :, None] * ref[..., c][:, None, :]
        cross = t if cross is None else cross + t
    return torch.clamp_min((q2 + r2) - 2.0 * cross, 0.0)


def blend3_plain(query: torch.Tensor, ref: torch.Tensor, flow: torch.Tensor):
    """query (B, N, 3), ref/flow (B, M >= 3, 3) -> (blended (B, N, 3),
    min_dist (B, N), flow_sqnorm_max (B, N)); see csrc/blend3.cu."""
    dk, ik = ksmallest(blend3_sqdist(query, ref), 3)          # (B, N, 3)
    return blend3_epilogue(dk, ik, flow)


def blend3_epilogue(dk: torch.Tensor, ik: torch.Tensor, flow: torch.Tensor):
    """The blend from the 3 nearest anchors' distances dk (B, N, 3) and
    indices ik: blend3_plain's outputs, in the kernel's order of operations.
    """
    dist = torch.clamp_min(torch.sqrt(torch.clamp_min(dk, 0.0)), 1e-10)
    w = 1.0 / dist
    wsum = (w[..., 0] + w[..., 1]) + w[..., 2]
    f = [_gather_rows(flow, ik[..., j]) for j in range(3)]    # 3 x (B, N, 3)
    blended = (w[..., 0:1] * f[0] + w[..., 1:2] * f[1]) + w[..., 2:3] * f[2]
    fs = [_sqnorm(fj) for fj in f]
    flow_d = torch.maximum(torch.maximum(fs[0], fs[1]), fs[2])
    return blended / wsum[..., None], dist[..., 0], flow_d


def blend3_slices(b: int, n: int, m: int, sms: int) -> int:
    """S, the slices blend3's kernel cuts the M anchors into for a (B, N, M)
    call on a card of `sms` SMs: doubled from 1 while the grid holds fewer
    than 8 blocks an SM and each slice keeps BLEND3_MIN_SLICE anchors or
    more, up to BLEND3_MAX_SLICES. (9, 4096, 4096) on 132 SMs takes 8."""
    s = 1
    while (s < BLEND3_MAX_SLICES and m >= 2 * s * BLEND3_MIN_SLICE
           and b * -(-n * s // BLEND3_QUERIES) < 8 * sms):
        s *= 2
    return s


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
    slices = blend3_slices(b, n, m, _build.sm_count(query.device))
    lib = _build.load_library()
    with torch.cuda.device(query.device):
        err = lib.reart_blend3(
            query.data_ptr(), ref.data_ptr(), flow.data_ptr(), b, n, m,
            slices, out.data_ptr(), min_d.data_ptr(), flow_d.data_ptr(),
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


def nn_topk_blocks(b: int, n: int, qpt: int, slices: int) -> int:
    """Blocks of nn_topk's kernel for b clouds of n queries."""
    return b * -(-n * slices // (NN_THREADS * qpt))


def nn_topk_plan(b: int, n: int, m: int, k: int, sms: int,
                 qpt: int = NN_QPT) -> tuple[int, int]:
    """(queries a thread, slices S) of nn_topk's kernel for b reference
    clouds of m points, each against n queries (the clouds that share a
    reference folded into one), k neighbours, on a card of `sms` SMs, for a
    library built with `qpt` as REART_NN_QPT. k = 1 takes qpt queries a
    thread where a cloud fills a block with them (one shared-memory load of
    a point then serves qpt pairs), else 1; k > 1 takes 1 (the inserts into
    qpt lists a thread serialise). S is doubled from 1 while the grid holds
    fewer than NN_BLOCKS_PER_SM[k > 1] blocks an SM and each slice keeps
    NN_MIN_SLICE points or more, up to NN_MAX_SLICES: k > 1 stops earlier,
    since each slice keeps a top-k of its own and shorter slices insert
    more. On 132 SMs: the seg-refinement table (9, 81920, 4096), k=1, takes
    (4, 1); (9, 4096, 4096) (4, 16) at k=1 and (1, 2) at k=3; IK's
    (1, 6, 4096) (1, 16). The choice changes no bit of the result."""
    qpt = qpt if k == 1 and n >= qpt * NN_THREADS else 1
    per_sm = NN_BLOCKS_PER_SM[k > 1]
    s = 1
    while (s < NN_MAX_SLICES and m >= 2 * s * NN_MIN_SLICE
           and nn_topk_blocks(b, n, qpt, s) < per_sm * sms):
        s *= 2
    return qpt, s


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
        # the ref_div clouds that read one reference are one cloud of
        # ref_div * N queries to the kernel
        bf, nf = b // ref_div, n * ref_div
        qpt, slices = nn_topk_plan(bf, nf, m, k, _build.sm_count(q.device))
        if nn_topk_blocks(bf, nf, qpt, slices) > MAX_BLOCKS or nf > MAX_BLOCKS:
            raise ValueError(f"{name}: batch {b} x {n} queries x {m} points "
                             f"is past the grid limit")
        d = torch.empty((b, n, k), dtype=torch.float32, device=q.device)
        i = torch.empty((b, n, k), dtype=torch.int64, device=q.device)
        lib = _build.load_library()
        with torch.cuda.device(q.device):
            err = lib.reart_nn_topk(q.data_ptr(), r.data_ptr(), bf, nf, m, k,
                                    qpt, slices, d.data_ptr(), i.data_ptr(),
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


def nn1_coords_plan(b: int, n: int, m: int, sms: int,
                    qpt: int = NN_QPT) -> tuple[str, int, int]:
    """The route of nn1_coords' kernel for b pairs of clouds, n queries
    against m points each, on a card of `sms` SMs: ("packed", lanes a pair,
    NN1C_WARPS warps a block) where both clouds fit NN1C_MAX_PACKED points,
    the fewest lanes of NN1C_LANES that hold both; else ("topk", queries a
    thread, slices), nn_topk_plan's for k = 1. The graph stage's (P^2, 20,
    20) takes ("packed", 32, 3): at P = 20, 134 blocks of 3 pairs; at the
    P = 6, 5, 4 of the full-width runs, 12, 9 or 6 blocks."""
    if n > NN1C_MAX_PACKED or m > NN1C_MAX_PACKED:
        return ("topk",) + nn_topk_plan(b, n, m, 1, sms, qpt)
    return "packed", min(w for w in NN1C_LANES if w >= max(n, m)), NN1C_WARPS


def nn1_coords_blocks(b: int, n: int, plan: tuple[str, int, int]) -> int:
    """Blocks of nn1_coords' first kernel for b pairs of n queries."""
    route, a, c = plan
    if route == "packed":
        return -(-b // (c * 32 // a))
    return nn_topk_blocks(b, n, a, c)


def nn1_coords(query: torch.Tensor, ref: torch.Tensor):
    """1-NN with the winner's coords; see nn1_coords_plain."""
    name = "nn1_coords"
    _check_clouds(name, query, ref, max_batch=MAX_BLOCKS)
    if _build.is_cpu(name, query):
        return nn1_coords_plain(query, ref)
    _build.require_cuda(name, query, ref, dtype=torch.float32)
    b, n, m = query.shape[0], query.shape[1], ref.shape[1]
    plan = nn1_coords_plan(b, n, m, _build.sm_count(query.device))
    if (nn1_coords_blocks(b, n, plan) > MAX_BLOCKS
            or -(-b * n // 256) > MAX_BLOCKS):
        raise ValueError(f"{name}: batch {b} x {n} queries is past the grid "
                         f"limit")
    d = torch.empty((b, n), dtype=torch.float32, device=query.device)
    i = torch.empty((b, n), dtype=torch.int64, device=query.device)
    c = torch.empty((b, n, 3), dtype=torch.float32, device=query.device)
    lib = _build.load_library()
    with torch.cuda.device(query.device):
        err = lib.reart_nn1_coords(
            query.data_ptr(), ref.data_ptr(), b, n, m,
            int(plan[0] == "topk"), plan[1], plan[2], d.data_ptr(),
            i.data_ptr(), c.data_ptr(), _build.stream_of(query))
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


def nn_bidir_units(b: int, n: int, m: int, warps: int, run: int) -> int:
    """Units of nn_bidir's scan for b clouds of n src rows against m tgt
    columns: row blocks of warps * NN_BIDIR_RT rows times chunks of 32 run
    columns, as csrc/nn_bidir.cu cuts the plane."""
    return b * -(-n // (warps * NN_BIDIR_RT)) * -(-m // (32 * run))


def nn_bidir_plan(b: int, n: int, m: int,
                  sms: int) -> tuple[int, int, int]:
    """(warps a block W, run L, blocks G) of nn_bidir's scan for b clouds of
    n src rows against m tgt columns on a card of `sms` SMs. W: the power of
    two up to NN_BIDIR_MAX_WARPS that holds the n rows at NN_BIDIR_RT a
    warp; L: the m columns over 32 lanes, up to NN_BIDIR_MAX_RUN; G: the
    blocks every SM holds at once (NN_BIDIR_WARPS_PER_SM / W, at most NN_BIDIR_BLOCKS_PER_SM), or the
    units where there are fewer. On 132 SMs the Chamfer metric's (9, 7 or
    5, 4096, 4096) take (8, 16, 264): 2304, 1792 or 1280 units of 128 rows
    x 512 columns over 264 blocks. The choice changes no bit of the
    result."""
    warps = 1
    while warps < NN_BIDIR_MAX_WARPS and warps * NN_BIDIR_RT < n:
        warps *= 2
    run = min(NN_BIDIR_MAX_RUN, -(-m // 32))
    per_sm = min(NN_BIDIR_BLOCKS_PER_SM, NN_BIDIR_WARPS_PER_SM // warps)
    return warps, run, min(nn_bidir_units(b, n, m, warps, run), per_sm * sms)


def nn_bidir(src: torch.Tensor, tgt: torch.Tensor):
    """Bidirectional 1-NN without coords; see nn_bidir_plain."""
    name = "nn_bidir"
    _check_clouds(name, src, tgt, max_batch=MAX_BLOCKS)
    if _build.is_cpu(name, src):
        return nn_bidir_plain(src, tgt)
    _build.require_cuda(name, src, tgt, dtype=torch.float32)
    b, n, m = src.shape[0], src.shape[1], tgt.shape[1]
    warps, run, blocks = nn_bidir_plan(b, n, m, _build.sm_count(src.device))
    if -(-b * (n + m) // 256) > MAX_BLOCKS:
        raise ValueError(f"{name}: batch {b} x {n} x {m} points is past the "
                         f"grid limit")
    f32 = dict(dtype=torch.float32, device=src.device)
    i64 = dict(dtype=torch.int64, device=src.device)
    fd, fi = torch.empty((b, n), **f32), torch.empty((b, n), **i64)
    bd, bi = torch.empty((b, m), **f32), torch.empty((b, m), **i64)
    # the (distance, group) keys of the merge; the kernel sets them
    fkey, bkey = torch.empty((b, n), **i64), torch.empty((b, m), **i64)
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.reart_nn_bidir(src.data_ptr(), tgt.data_ptr(), b, n, m,
                                 warps, run, blocks, fd.data_ptr(),
                                 fi.data_ptr(), bd.data_ptr(), bi.data_ptr(),
                                 fkey.data_ptr(), bkey.data_ptr(),
                                 _build.stream_of(src))
    _build.check_launch(name, err)
    nn_bidir.launches += 1
    return fd, fi, bd, bi


nn_bidir.launches = 0


# ---------------------------------------------------------------------------
# ball_query
# ---------------------------------------------------------------------------

def radius_sq(radius: float) -> float:
    """radius^2 as the JAX package compares against it: the product in
    double, rounded once to float32."""
    return torch.tensor(float(radius) * float(radius),
                        dtype=torch.float32).item()


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3), centroids new_xyz (B, S, 3) -> (B, S, nsample) int64:
    the indices j with sqdist(new_xyz[b, s], xyz[b, j]) < radius^2 (strict),
    ascending, the first nsample of them; slots past the last hit hold the
    first hit, a centroid without a hit holds 0 throughout. The nsample
    smallest of the key (j for a hit, j + N otherwise) are the hits in point
    order; the keys are distinct, so their order is unique. Chunked over the
    batch like nn_topk_plain."""
    b, n, s = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    r2 = radius_sq(radius)
    k = min(nsample, n)
    cols = torch.arange(n, dtype=torch.int32, device=xyz.device)
    outs = []
    for b0, b1 in _batch_chunks(b, s, n):
        hit = _sqdist_diff2(new_xyz[b0:b1], xyz[b0:b1]) < r2     # (b, S, N)
        key = torch.where(hit, cols, cols + n)
        sel = torch.topk(key, k, dim=-1, largest=False, sorted=True)[0]
        idx = torch.where(sel < n, sel, sel - n).to(torch.int64)
        first = idx[..., :1]
        idx = torch.where(sel < n, idx, first)
        if k < nsample:
            idx = torch.cat([idx, first.expand(-1, -1, nsample - k)], -1)
        outs.append(idx)
    return torch.cat(outs)


def ball_query_warps(b: int, s: int, sms: int) -> int:
    """Centroids (warps) a block of ball_query's kernel for b clouds of s
    centroids on a card of `sms` SMs: the W in [BQ_MIN_WARPS, BQ_MAX_WARPS]
    that puts the fewest warps on the busiest SM, ceil(blocks / sms) * W,
    the larger W on a tie (fewer copies of the cloud). On 132 SMs: SA1 of
    the flow clouds, (9, 512), takes 12 (387 blocks, 3 an SM); SA1 of a
    training batch, (8, 512), 16; SA2, (9, 128) 10 and (8, 128) 8."""
    return min(range(BQ_MAX_WARPS, BQ_MIN_WARPS - 1, -1),
               key=lambda w: -(-b * -(-s // w) // sms) * w)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """First `nsample` in-radius points of each centroid, in point order;
    see ball_query_plain. Not differentiable."""
    name = "ball_query"
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    _check_clouds(name, xyz, new_xyz, max_batch=MAX_BLOCKS)
    if nsample < 1 or not radius > 0:
        raise ValueError(f"{name}: needs nsample >= 1 and radius > 0, got "
                         f"{nsample} and {radius}")
    if _build.is_cpu(name, xyz):
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    xyz, new_xyz = xyz.contiguous(), new_xyz.contiguous()
    _build.require_cuda(name, xyz, new_xyz, dtype=torch.float32)
    b, n, s = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    warps = ball_query_warps(b, s, _build.sm_count(xyz.device))
    if b * (-(-s // warps)) > MAX_BLOCKS:
        raise ValueError(f"{name}: batch {b} x {s} centroids is past the "
                         f"grid limit")
    out = torch.empty((b, s, nsample), dtype=torch.int64, device=xyz.device)
    lib = _build.load_library()
    with torch.cuda.device(xyz.device):
        err = lib.reart_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), b, n,
                                   s, radius_sq(radius), nsample, warps,
                                   out.data_ptr(), _build.stream_of(xyz))
    _build.check_launch(name, err)
    ball_query.launches += 1
    return out


ball_query.launches = 0
