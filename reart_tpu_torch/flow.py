"""Descriptor matching and flow supervision setup (reart_tpu/flow.py).

The matchers return fixed-shape per-point indices and validity masks (one
top-2 over a distance matrix per frame pair, all pairs in one batch) and run
on the device of the descriptors; the ragged anchor lists are compacted on
the host when the FlowContext is packed, once per fit. The chaining, the
displacement gate and the local-rigid refinement are host-side numpy, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import device_of, to_numpy
from reart_tpu_torch.ops.cuda_nn import ksmallest
from reart_tpu_torch.ops.distance import pairwise_sqdist
from reart_tpu_torch.train.engine import FlowContext


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., M), idx (..., N) -> values[..., idx] (..., N)."""
    return torch.gather(values, -1, idx)


def match_snn(desc1: torch.Tensor, desc2: torch.Tensor, th: float = 0.9,
              dm: torch.Tensor | None = None):
    """First-to-second nearest-neighbour ratio test. desc1 (..., N1, D),
    desc2 (..., N2, D) -> (ratio (..., N1), idx_in_2 (..., N1), valid
    (..., N1) bool). Equal distances keep ascending index (two masked argmin
    passes); identical descriptors give 0 / 0 = nan, which is not valid."""
    if dm is None:
        dm = torch.sqrt(pairwise_sqdist(desc1, desc2))
    vals, idxs = ksmallest(dm, 2)
    ratio = vals[..., 0] / vals[..., 1]
    return ratio, idxs[..., 0], ratio <= th


def match_smnn(desc1: torch.Tensor, desc2: torch.Tensor, th: float = 0.9,
               dm: torch.Tensor | None = None):
    """Symmetric (mutual) SNN matching. Returns (dists (..., N1), tgt_idx
    (..., N1), valid (..., N1)): point i of desc1 matches tgt_idx[i] of desc2
    where valid[i]; dists is the larger of the two directional ratios."""
    if dm is None:
        dm = torch.sqrt(pairwise_sqdist(desc1, desc2))
    r12, nn12, m12 = match_snn(desc1, desc2, th, dm)
    r21, nn21, m21 = match_snn(desc2, desc1, th, dm.transpose(-1, -2))
    j = nn12
    rows = torch.arange(dm.shape[-2], device=dm.device)
    mutual = m12 & _take(m21, j) & (_take(nn21, j) == rows)
    dists = torch.maximum(r12, _take(r21, j))
    return dists, j, mutual


def find_mutual_correspondences(nns01: torch.Tensor, nns10: torch.Tensor):
    """Plain mutual-NN filter: (tgt_idx (..., N0), valid (..., N0))."""
    idx0 = torch.arange(nns01.shape[-1], device=nns01.device)
    return nns01, _take(nns10, nns01) == idx0


def normalize_pc_list(pc_list, centroid, scale):
    return (pc_list - centroid) * scale


def _match_pairs(src_feat, tgt_feat, matching: str, th: float):
    """(tgt_idx (P, N), valid (P, N)) of P frame pairs at once."""
    if matching == "mnn":
        nns01 = torch.argmin(pairwise_sqdist(src_feat, tgt_feat), dim=-1)
        nns10 = torch.argmin(pairwise_sqdist(tgt_feat, src_feat), dim=-1)
        return find_mutual_correspondences(nns01, nns10)
    if matching == "smnn":
        _, j, valid = match_smnn(src_feat, tgt_feat, th)
        return j, valid
    raise ValueError(f"unknown matching {matching}")


@torch.no_grad()
def compute_corr_masks(norm_pc_list, extract_fn, matching: str = "smnn",
                       th: float = 0.9, device=None):
    """Correspondences for every consecutive frame pair. norm_pc_list
    (T, N, 3) normalised clouds (array or tensor; an array goes to `device`,
    the card when None); extract_fn: (T', N, 3) tensor -> (T', N, D)
    descriptors. Returns tensors (tgt_idx (T-1, N), valid (T-1, N))."""
    dev = device_of(norm_pc_list, device=device)
    pcs = torch.as_tensor(norm_pc_list, dtype=torch.float32, device=dev)
    src_feat = extract_fn(pcs[:-1]).detach()
    tgt_feat = extract_fn(pcs[1:]).detach()
    return _match_pairs(src_feat, tgt_feat, matching, th)


@torch.no_grad()
def cycle_chain_matches(norm_pcs, feats, tgt_idx, valid, th: float = 0.9,
                        close_r: float = 0.04, drop_broken: bool = True,
                        device=None):
    """Cycle-consistent match chaining over frame triples (t, t+1, t+2).

    Two paths lead from frame t to frame t+2: the composition of the
    consecutive matches and the direct skip match (SMNN on the same
    features). Where both exist they vote on each other: a chain whose two
    endpoints land within `close_r` closes and confirms both consecutive
    matches on it; a chain that lands far breaks, and a consecutive match
    that breaks chains and closes none is dropped; a skip match whose target
    has an inverse under the adjacent consecutive pair fills a hole with the
    inferred match. norm_pcs (T, N, 3) the normalised clouds the features
    came from; feats (T, N, D); tgt_idx / valid (T-1, N). Only the T-2
    skip-pair matches run on the device (that of `feats`, or `device`).
    Returns numpy copies (tgt_idx, valid)."""
    pcs = to_numpy(norm_pcs).astype(np.float32)
    t_frames, n = pcs.shape[0], pcs.shape[1]
    j1 = to_numpy(tgt_idx).copy()
    v1 = to_numpy(valid).astype(bool).copy()
    if t_frames < 3:
        return j1, v1

    dev = device_of(feats, device=device)
    feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
    _, j2, v2 = match_smnn(feats[:-2], feats[2:], th)
    j2, v2 = to_numpy(j2), to_numpy(v2).astype(bool)

    closed = np.zeros((t_frames - 1, n), np.int32)
    broken = np.zeros((t_frames - 1, n), np.int32)
    adds: list[tuple[int, np.ndarray, np.ndarray]] = []
    for t in range(t_frames - 2):
        a_j, a_v = j1[t], v1[t]
        b_j, b_v = j1[t + 1], v1[t + 1]
        s_j, s_v = j2[t], v2[t]
        comp = b_j[a_j]                      # composed target in frame t+2
        both = a_v & b_v[a_j] & s_v
        dist = np.linalg.norm(pcs[t + 2][comp] - pcs[t + 2][s_j], axis=-1)
        ok = both & (dist <= close_r)
        bad = both & ~ok
        np.add.at(closed[t], np.flatnonzero(ok), 1)
        np.add.at(closed[t + 1], a_j[ok], 1)
        np.add.at(broken[t], np.flatnonzero(bad), 1)
        np.add.at(broken[t + 1], a_j[bad], 1)

        # densify pair t: hole i, skip i->j2, inverse of (t+1, t+2) at j2
        inv_b = np.full(n, -1, np.int64)
        inv_b[b_j[b_v]] = np.flatnonzero(b_v)
        cand = ~a_v & s_v & (inv_b[s_j] >= 0)
        adds.append((t, np.flatnonzero(cand), inv_b[s_j[cand]]))
        # densify pair t+1: i -> x matched, i skip-matched, x unmatched
        cand2 = a_v & s_v & ~b_v[a_j]
        adds.append((t + 1, a_j[cand2], s_j[cand2]))

    if drop_broken:
        v1 &= ~((broken > 0) & (closed == 0))
    for t, rows, targets in adds:
        fresh = ~v1[t][rows]  # never overwrite a surviving direct match
        j1[t][rows[fresh]] = targets[fresh]
        v1[t][rows[fresh]] = True
    return j1, v1


def gate_matches_by_displacement(pcs, tgt_idx, valid, k_mad: float = 6.0):
    """Robust displacement-outlier filter over per-pair matches: per frame
    pair, drop matches whose displacement norm exceeds median + k_mad * MAD
    of the valid matches (MAD floored at 1% of the pair's median). pcs
    (T, N, 3) un-normalised clouds; tgt_idx / valid (T-1, N). Returns the
    tightened valid mask (numpy)."""
    pcs = to_numpy(pcs).astype(np.float32)
    tgt_idx = to_numpy(tgt_idx)
    valid = to_numpy(valid).copy()
    for t in range(pcs.shape[0] - 1):
        v = valid[t]
        if v.sum() < 8:
            continue
        disp = np.linalg.norm(
            pcs[t + 1][tgt_idx[t]] - pcs[t], axis=-1)  # (N,)
        med = np.median(disp[v])
        mad = np.median(np.abs(disp[v] - med))
        cut = med + k_mad * max(mad, 0.01 * max(med, 1e-12))
        valid[t] = v & (disp <= cut)
    return valid


def refine_targets_local_rigid(src, tgt, k: int = 16, rounds: int = 2,
                               keep_frac: float = 0.5):
    """Continuous match targets from local rigid fits (trimmed Procrustes).

    src/tgt: (M, 3) matched anchor pairs of one frame pair (numpy). A raw
    matched target is a point of the next frame's discrete sample, so even a
    perfect match carries about the surface point spacing as error.
    Articulated motion is locally rigid: fitting R, t over each anchor's k
    nearest matched neighbours and predicting `R @ src_i + t` averages the
    sampling noise. Trimming rejects neighbours from across part boundaries;
    anchors whose own residual under their neighbourhood fit stays large
    keep their discrete target. Returns refined targets (M, 3)."""
    m = src.shape[0]
    if m < 5:
        return tgt
    k = int(min(k, m - 1))
    d2 = ((src[:, None] - src[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)  # a fit must not lean on its own match
    nbr = np.argpartition(d2, k - 1, axis=1)[:, :k]  # (M, k)
    p = src[nbr]  # (M, k, 3)
    q = tgt[nbr]

    def fit(w):
        """Batched weighted Kabsch: H = sum_k w_k (p_k-cp)(q_k-cq)^T,
        R = V S U^T; returns (R, t, per-neighbour residuals)."""
        ws = w.sum(1, keepdims=True)[..., None]  # (M, 1, 1)
        cp = (w[..., None] * p).sum(1, keepdims=True) / ws
        cq = (w[..., None] * q).sum(1, keepdims=True) / ws
        h = np.einsum("mk,mki,mkj->mij", w, p - cp, q - cq)
        u, _, vt = np.linalg.svd(h)
        v, ut = vt.transpose(0, 2, 1), u.transpose(0, 2, 1)
        s = np.repeat(np.eye(3)[None], m, 0)
        s[:, 2, 2] = np.sign(np.linalg.det(v @ ut))
        r = v @ s @ ut  # (M, 3, 3), maps p onto q
        tvec = cq[:, 0] - (r @ cp[:, 0, :, None])[:, :, 0]
        resid = np.linalg.norm(
            (r[:, None] @ p[..., None])[..., 0] + tvec[:, None] - q, axis=-1)
        return r, tvec, resid

    # 1. trim down to a 4-neighbour core: residual-ordered halving under
    # successive refits makes mixed (part-boundary) neighbourhoods commit
    # to one part
    w = np.ones((m, k), np.float32)
    keep = k
    while keep > 4:
        r, tvec, resid = fit(w)
        keep = max(4, keep // 2)
        cut = np.partition(resid, keep - 1, axis=1)[:, keep - 1:keep]
        w = (resid <= cut).astype(np.float32)
    r, tvec, resid = fit(w)
    # 2. global sampling-noise scale: a 4-point rigid fit near-interpolates,
    # so its own residuals cannot estimate the noise; the best-half
    # residuals of all anchors under their core fits can
    half = np.sort(resid, axis=1)[:, :max(4, int(np.ceil(k * keep_frac)))]
    sigma = max(float(np.median(half)), 1e-9)
    # 3. expand back to every neighbour consistent with the core fit at the
    # noise scale and refit once: this is where the averaging happens
    rms4 = np.sqrt((w * resid ** 2).sum(1) / w.sum(1))
    thr = np.maximum(3.0 * rms4, 3.0 * sigma)[:, None]
    w = np.maximum((resid <= thr).astype(np.float32), w)
    r, tvec, resid = fit(w)
    refined = (r @ src[..., None])[..., 0] + tvec
    # 4. keep the raw discrete target where the local-rigid premise failed
    own_resid = np.linalg.norm(refined - tgt, axis=-1)
    bad = own_resid > 4.0 * sigma
    refined[bad] = tgt[bad]
    return refined.astype(np.float32)


@torch.no_grad()
def build_flow_context(complete_pc_list, extract_fn=None, centroid=None,
                       scale=None, matching: str = "smnn", th: float = 0.9,
                       corr: tuple | None = None, disp_gate: float = 0.0,
                       rigid_refine_k: int = 0, chain_r: float = 0.0,
                       device=None) -> FlowContext:
    """One-time flow-supervision setup: match every consecutive pair, then
    anchor flows at the matched source points.

    complete_pc_list: (T, N, 3) un-normalised clouds (the canonical frame at
    its original position). Matching runs on normalised clouds when
    centroid / scale are given. `corr=(tgt_idx, valid)` reuses precomputed
    correspondences. disp_gate > 0 drops displacement outliers (k_mad = the
    value); rigid_refine_k > 0 replaces each target by its local rigid fit's
    prediction; chain_r > 0 chains matches over frame triples with that
    closure radius (normalised units). The descriptors, the matching and the
    returned FlowContext live on `device` (the card when None)."""
    dev = device_of(device=device)
    pcs = to_numpy(complete_pc_list).astype(np.float32)
    if corr is None:
        if extract_fn is None:
            raise ValueError("need a feature extractor or corr")
        norm = pcs if centroid is None else normalize_pc_list(
            pcs, np.asarray(centroid, np.float32), np.float32(scale))
        norm_t = torch.as_tensor(norm, dtype=torch.float32, device=dev)
        if chain_r > 0.0:
            # extract once (T passes instead of 2(T-1)), reuse the features
            # for the consecutive matches and the skip-pair chains
            feats = extract_fn(norm_t).detach()
            tgt_idx, valid = _match_pairs(feats[:-1], feats[1:], matching,
                                          th)
            tgt_idx, valid = cycle_chain_matches(norm, feats, tgt_idx, valid,
                                                 th=th, close_r=chain_r)
        else:
            tgt_idx, valid = compute_corr_masks(norm_t, extract_fn, matching,
                                                th)
    else:
        tgt_idx, valid = corr
    tgt_idx = to_numpy(tgt_idx)
    valid = to_numpy(valid).astype(bool)
    if disp_gate > 0.0:
        valid = gate_matches_by_displacement(pcs, tgt_idx, valid, disp_gate)

    pc_refs, flow_refs = [], []
    for t in range(pcs.shape[0] - 1):
        src_pts = pcs[t][valid[t]]
        tgt_pts = pcs[t + 1][tgt_idx[t][valid[t]]]
        if rigid_refine_k > 0:
            tgt_pts = refine_targets_local_rigid(src_pts, tgt_pts,
                                                 k=rigid_refine_k)
        pc_refs.append(src_pts)
        flow_refs.append(tgt_pts - src_pts)
    return FlowContext.from_lists(pc_refs, flow_refs, device=dev)
