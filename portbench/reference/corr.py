"""The plain reference of a training step of the correspondence backbone
(stevenlsw/reart's PointNet++ MSG `PointNet2Msg2`, trained self-supervised
on synthetic rigid-part deformations of the sequence's own frames).

Plain PyTorch in float32 with TF32 off; it imports nothing of the program
and takes none of its derived data. From the step's random draws (made by
the benchmark) and the frames it builds the synthetic pair, runs the
backbone on both clouds in one batch with BatchNorm on the batch's moments
(biased variance), takes the bidirectional InfoNCE with the radius gates,
and Adam's update:

  pair     a frame's points split into random Voronoi parts, each part
           turned about its centroid and slid, a global motion on the
           target, per-point jitter, one rescale per pair
  SA1/SA2  farthest-point centroids (from index 0, ties to the lowest),
           the first `k` points within each radius in point order (padded
           with the first; none: index 0), the 1x1 conv + BN + ReLU stack
           on [features, centred xyz], max over the group
  SA3      the stack on [xyz, features] of every point, max
  FP       the 3-NN inverse squared distance interpolation (1 / (d + 1e-8),
           normalised), [skip, interpolated], the stack
  head     conv + BN + ReLU to 64 channels
  loss     features normalised (norm + 1e-8); logits f1 f2^T / T; src i's
           positive the target point nearest its true position, valid only
           within pos_radius (x the pair's scale), other target points
           within neg_radius left out (-1e9); the mean over valid rows of
           logsumexp - positive, both directions averaged

Parameters are keyed as the published model's modules are nested:
`sa1.<block>.<layer>.<weight|bias|bn_weight|bn_bias>`, `sa3.<layer>...`,
`fp3.<layer>...`, `head...`.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from reference.ops import fps
from reference.ops import gather as _gather

BN_EPS = 1e-5
SA1 = (512, (0.05, 0.1, 0.2), (32, 64, 128),
       ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA2 = (128, (0.2, 0.4), (64, 128), ((128, 128, 256), (128, 196, 256)))
SA3_MLP = (256, 512, 1024)
FP3, FP2, FP1 = (256, 256), (256, 128), (128, 128)


def layer_shapes(out_dim: int = 64) -> dict:
    """{layer prefix: (c_in, c_out)} of every conv + BN layer."""
    out = {}
    for name, c_in, spec in (("sa1", 3 + 3, SA1), ("sa2", 320 + 3, SA2)):
        for bi, mlp in enumerate(spec[3]):
            c = c_in
            for li, c_out in enumerate(mlp):
                out[f"{name}.{bi}.{li}"] = (c, c_out)
                c = c_out
    for name, c_in, mlp in (("sa3", 512 + 3, SA3_MLP), ("fp3", 1536, FP3),
                            ("fp2", 576, FP2), ("fp1", 134, FP1)):
        for li, c_out in enumerate(mlp):
            out[f"{name}.{li}"] = (c_in, c_out)
            c_in = c_out
    out["head"] = (128, out_dim)
    return out


def _sqdist(a, b):
    """(B, N, 3), (B, M, 3) -> (B, N, M), (dx^2 + dy^2) + dz^2."""
    d = None
    for c in range(3):
        diff = a[..., c][:, :, None] - b[..., c][:, None, :]
        d = diff * diff if d is None else d + diff * diff
    return d


@torch.no_grad()
def ball_query(radius, nsample, xyz, centres):
    """The first nsample point indices within `radius` (strictly, against
    radius^2 rounded once to float32) of each centre, in point order,
    padded with the first; 0 throughout where none is."""
    n = xyz.shape[1]
    r2 = torch.tensor(float(radius) * float(radius),
                      dtype=torch.float32).item()
    hit = _sqdist(centres, xyz) < r2
    cols = torch.arange(n, device=xyz.device)
    key = torch.where(hit, cols, cols + n)
    k = min(nsample, n)
    sel = key.topk(k, dim=-1, largest=False, sorted=True)[0]
    idx = torch.where(sel < n, sel, sel - n)
    first = idx[..., :1]
    idx = torch.where(sel < n, idx, first)
    if k < nsample:
        idx = torch.cat([idx, first.expand(-1, -1, nsample - k)], -1)
    return idx


@torch.no_grad()
def knn3(query, ref):
    """The 3 nearest reference indices, ascending, ties to the lowest."""
    d = _sqdist(query, ref)
    idx = []
    for _ in range(min(3, ref.shape[1])):
        i = d.argmin(-1, keepdim=True)
        idx.append(i)
        d = d.scatter(-1, i, float("inf"))
    return torch.cat(idx, -1)


def conv_bn(p, name, x, relu=True):
    y = F.linear(x, p[f"{name}.weight"]) + p[f"{name}.bias"]
    axes = tuple(range(y.dim() - 1))
    mean = y.mean(dim=axes)
    var = y.var(dim=axes, unbiased=False)
    y = (y - mean) / torch.sqrt(var + BN_EPS)
    y = y * p[f"{name}.bn_weight"] + p[f"{name}.bn_bias"]
    return F.relu(y) if relu else y


def _sa_msg(p, name, spec, xyz, points):
    npoint, radii, nsamples, mlps = spec
    new_xyz = _gather(xyz, fps(xyz, npoint))
    outs = []
    for bi, (radius, k) in enumerate(zip(radii, nsamples)):
        gidx = ball_query(radius, k, xyz, new_xyz)
        feat = torch.cat([_gather(points, gidx),
                          _gather(xyz, gidx) - new_xyz[:, :, None, :]], -1)
        for li in range(len(mlps[bi])):
            feat = conv_bn(p, f"{name}.{bi}.{li}", feat)
        outs.append(feat.amax(dim=2))
    return new_xyz, torch.cat(outs, -1)


def _fp(p, name, n_layers, xyz1, xyz2, points1, points2):
    b, n, _ = xyz1.shape
    if xyz2.shape[1] == 1:
        interp = points2.expand(b, n, points2.shape[-1])
    else:
        idx = knn3(xyz1, xyz2)
        diff = xyz1[..., None, :] - _gather(xyz2, idx)
        w = 1.0 / ((diff * diff).sum(-1) + 1e-8)
        w = w / w.sum(-1, keepdim=True)
        interp = (_gather(points2, idx) * w[..., None]).sum(-2)
    feat = interp if points1 is None else torch.cat([points1, interp], -1)
    for li in range(n_layers):
        feat = conv_bn(p, f"{name}.{li}", feat)
    return feat


def backbone(p, xyz):
    """xyz (B, N, 3) -> (B, N, out_dim), BatchNorm on the batch."""
    l1_xyz, l1 = _sa_msg(p, "sa1", SA1, xyz, xyz)
    l2_xyz, l2 = _sa_msg(p, "sa2", SA2, l1_xyz, l1)
    feat = torch.cat([l2_xyz, l2], -1)[:, None]
    for li in range(len(SA3_MLP)):
        feat = conv_bn(p, f"sa3.{li}", feat)
    l3 = feat.amax(dim=2)
    l3_xyz = torch.zeros((xyz.shape[0], 1, 3), device=xyz.device)
    l2 = _fp(p, "fp3", len(FP3), l2_xyz, l3_xyz, l2, l3)
    l1 = _fp(p, "fp2", len(FP2), l1_xyz, l2_xyz, l1, l2)
    l0 = _fp(p, "fp1", len(FP1), xyz, l1_xyz, torch.cat([xyz, xyz], -1), l1)
    return conv_bn(p, "head", l0)


def so3_exp(log_rot, eps=1e-4):
    nrms = (log_rot * log_rot).sum(-1)
    ang = torch.sqrt(torch.clamp_min(nrms, eps))
    inv = 1.0 / ang
    fac1 = inv * torch.sin(ang)
    fac2 = inv * inv * (1.0 - torch.cos(ang))
    x, y, z = log_rot[..., 0], log_rot[..., 1], log_rot[..., 2]
    zero = torch.zeros_like(x)
    skew = torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, device=log_rot.device)
    skew_sq = (log_rot[..., :, None] * log_rot[..., None, :]
               - nrms[..., None, None] * eye)
    return fac1[..., None, None] * skew + fac2[..., None, None] * skew_sq + eye


def make_pair(d: dict, frames, cfg: dict):
    """The synthetic pair of one step's draws -> (src, tgt, gt_pos,
    scale)."""
    n0 = frames.shape[1]
    n, kmax = cfg["n_points"], cfg["k_parts"]
    dev = frames.device
    cloud = frames[d["frame"]]
    x = _gather(cloud, d["perm"][:, :n])
    x2 = _gather(cloud, d["perm"][:, n0 - n:]) if cfg["resample"] else x
    seeds = _gather(x, d["seed_perm"][:, :kmax])
    active = torch.arange(kmax, device=dev)[None, :] < d["k_active"][:, None]

    def label_of(pts):
        d2 = ((pts[:, :, None] - seeds[:, None]) ** 2).sum(-1)
        return torch.where(active[:, None], d2,
                           torch.full_like(d2, float("inf"))).argmin(-1)

    label = label_of(x)
    onehot = F.one_hot(label, kmax).to(x.dtype)
    counts = onehot.sum(1)
    centroids = (torch.matmul(onehot.transpose(1, 2), x)
                 / torch.clamp_min(counts, 1.0)[..., None])
    axis = d["axis"] / (torch.linalg.norm(d["axis"], dim=-1, keepdim=True)
                        + 1e-8)
    rot = so3_exp(axis * d["angle"])
    slide = cfg["max_slide"] * d["slide"]
    gaxis = d["gaxis"] / (torch.linalg.norm(d["gaxis"], dim=-1, keepdim=True)
                          + 1e-8)
    grot = so3_exp(gaxis * d["gangle"][:, None])
    gslide = cfg["global_slide"] * d["gslide"]

    def move(pts, lab):
        c = _gather(centroids, lab)
        r = _gather(rot.reshape(rot.shape[0], kmax, 9), lab).reshape(
            lab.shape + (3, 3))
        out = torch.einsum("bnij,bnj->bni", r, pts - c) + c \
            + _gather(slide, lab)
        return torch.matmul(out, grot.transpose(1, 2)) + gslide[:, None, :]

    gt_pos = move(x, label)
    y = move(x2, label_of(x2)) if cfg["resample"] else gt_pos
    x = x + cfg["jitter"] * d["jitter_src"]
    y = y + cfg["jitter"] * d["jitter_tgt"]
    s = d["scale"]
    sb = s[:, None, None]
    return x * sb, y * sb, gt_pos * sb, s


def _nce(lg, is_pos, near, valid):
    lgm = torch.where(near, torch.full_like(lg, -1e9), lg)
    lse = torch.logsumexp(lgm, -1)
    pos = torch.where(is_pos, lgm, torch.zeros_like(lgm)).sum(-1)
    return ((lse - pos) * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


def info_nce(p, src, tgt, gt_pos, scale, cfg):
    b, n = src.shape[:2]
    feats = backbone(p, torch.cat([src, tgt], 0))
    feats = feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-8)
    f1, f2 = feats[:b], feats[b:]
    with torch.no_grad():
        d2 = ((gt_pos[:, :, None] - tgt[:, None]) ** 2).sum(-1)
        pos_r2 = (cfg["pos_radius"] * scale)[:, None] ** 2
        neg_r2 = (cfg["neg_radius"] * scale)[:, None, None] ** 2

        def gates(dd):
            dmin, pos = dd.min(-1)
            is_pos = F.one_hot(pos, dd.shape[-1]).bool()
            return is_pos, (dd < neg_r2) & ~is_pos, (dmin < pos_r2).float()

        gf, gb = gates(d2), gates(d2.transpose(1, 2))
    lg = torch.einsum("bnd,bmd->bnm", f1, f2) * (1.0 / cfg["temperature"])
    return 0.5 * (_nce(lg, *gf) + _nce(lg.transpose(1, 2), *gb))


def follow(p: dict, frames, draws: list, cfg: dict) -> dict:
    """len(draws) training steps from weights `p` with Adam (one group at
    cfg lr, reference/adam.py) -> {"losses", "grad0", "weights"}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reference import adam

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    names = list(leaves)
    states = [adam.new_state(leaves[k]) for k in names]
    losses, grad0 = [], None
    for d in draws:
        src, tgt, gt_pos, scale = make_pair(d, frames, cfg)
        loss = info_nce(leaves, src, tgt, gt_pos, scale, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = dict(zip(names, grads))
        adam.step([leaves[k] for k in names], list(grads), states, cfg["lr"])
    return {"losses": losses, "grad0": grad0,
            "weights": {k: v.detach() for k, v in leaves.items()}}
