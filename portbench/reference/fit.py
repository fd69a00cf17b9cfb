"""The plain reference of a relaxation fit's steps (stevenlsw/reart's
`--model base` training step, as the benchmark's configurations run it).

Plain PyTorch in float32 with TF32 off; it imports nothing of
the program and takes none of its derived data. Given the model's weights
and Adam's state before a step, the step's Gumbel draw and the inputs, it
computes the step's loss terms, the gradient and the updated weights and
state:

  logits = W1 relu(W0 x + b0)                     (N, P), per point x
  w      = hard Gumbel-softmax(logits, tau, g)    straight-through
  M_tp   = [R(6d_tp) | t_tp]                      3 x 4 per frame and part
  y_tn   = (sum_p w_np M_tp) [x_n; 1]             the predicted frames
  recon  = sum of both directions' squared 1-NN distances to the frames
  flow   = sum over points of mask |dy - f|^2 + 0.01 (1 - mask) |dy|^2,
           f the 3-NN inverse-distance blend of the anchors' flows at the
           predicted source points, dy the predicted motion
  assign = lambda_a sum |y_src - tgt[perm]|^2 over the FPS-downsampled
           clouds, perm the exact matching of least summed euclidean
           distance (stevenlsw/reart's Hungarian solve; scipy here),
           solved at every assign_gap-th iteration from assign_iter
  Adam (beta 0.9, 0.999, eps 1e-8; torch's own arithmetic, reference/
           adam.py): the seg MLP at seg_lr, the proposals at trans_lr.

Leaves are named w0, b0, w1 (the seg MLP) and p6d, pt (the proposals).
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from reference.ops import exact_matchings, fps, gather

LEAVES = ("w0", "b0", "w1", "p6d", "pt")
SEG_LEAVES = ("w0", "b0", "w1")


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tau_at(cur_iter: int, cfg: dict) -> torch.Tensor:
    """The cosine temperature, start_tau -> end_tau over n_iter, in float32,
    at cur_iter = iteration + 1."""
    frac = torch.tensor(cur_iter, dtype=torch.float32) / cfg["n_iter"]
    return cfg["end_tau"] + (cfg["start_tau"] - cfg["end_tau"]) * (
        torch.cos(math.pi * frac) + 1.0) * 0.5


def rot6d(d6: torch.Tensor) -> torch.Tensor:
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def forward(p: dict, cano: torch.Tensor, gumbel: torch.Tensor, tau):
    """-> predicted frames (T-1, N, 3)."""
    h = F.relu(F.linear(cano, p["w0"]) + p["b0"])
    logits = F.linear(h, p["w1"])
    y = torch.softmax((logits + gumbel) / tau, dim=-1)
    hard = F.one_hot(y.argmax(-1), y.shape[-1]).to(y.dtype)
    w = hard + y - y.detach()
    m34 = torch.cat([rot6d(p["p6d"]), p["pt"][..., None]], dim=-1)
    blended = torch.einsum("np,tpij->tnij", w, m34)
    xh = torch.cat([cano, torch.ones_like(cano[:, :1])], dim=-1)
    return torch.einsum("tnij,nj->tni", blended, xh)


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) -> (N, M) squared distances, difference by
    difference and summed (dx^2 + dy^2) + dz^2, as the configurations'
    neighbour search states it: a different order of the sum can turn a
    near tie the other way, and the gradient with it."""
    d = None
    for c in range(3):
        diff = a[:, None, c] - b[None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def recon(pred: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Both directions' squared 1-NN distances, summed: each frame's
    neighbours found without gradient (ties to the lowest index), then the
    matched pairs' distances taken again with it."""
    fwd, bwd = [], []
    for t in range(pred.shape[0]):
        with torch.no_grad():
            d = _sqdist(pred[t], frames[t])
            fwd.append(d.argmin(1))
            bwd.append(d.argmin(0))
    fi, bi = torch.stack(fwd), torch.stack(bwd)
    near_f = gather(frames, fi)                     # no gradient to frames
    near_b = gather(pred, bi)
    return ((pred - near_f) ** 2).sum(-1).sum() \
        + ((frames - near_b) ** 2).sum(-1).sum()


def _sqnorm(p):
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] \
        + p[..., 2] * p[..., 2]


@torch.no_grad()
def blend_flow(query: torch.Tensor, anchors: torch.Tensor,
               flows: torch.Tensor):
    """3-NN inverse-distance blend of the anchors' flows at the query
    points -> (blended (N, 3), mask (N,) bool): mask where the nearest
    anchor is no farther than the largest squared flow norm of the three,
    or than 0.05. Distances as the configurations' blend states them,
    |q|^2 + |r|^2 - 2 q.r clamped at 0, so that a point on the mask's
    threshold falls on the same side; the three nearest ascending, ties to
    the lowest index."""
    cross = None
    for c in range(3):
        t = query[:, c][:, None] * anchors[:, c][None, :]
        cross = t if cross is None else cross + t
    d = torch.clamp_min((_sqnorm(query)[:, None] + _sqnorm(anchors)[None])
                        - 2.0 * cross, 0.0)
    d2, idx = [], []
    for _ in range(3):
        i = d.argmin(1, keepdim=True)
        d2.append(torch.gather(d, 1, i))
        idx.append(i)
        d = d.scatter(1, i, float("inf"))
    d2, idx = torch.cat(d2, 1), torch.cat(idx, 1)
    dist = torch.clamp_min(torch.sqrt(torch.clamp_min(d2, 0.0)), 1e-10)
    w = 1.0 / dist
    wsum = (w[:, 0] + w[:, 1]) + w[:, 2]
    f = [flows[idx[:, j]] for j in range(3)]
    blended = (w[:, 0:1] * f[0] + w[:, 1:2] * f[1]) + w[:, 2:3] * f[2]
    fmax = torch.maximum(torch.maximum(_sqnorm(f[0]), _sqnorm(f[1])),
                         _sqnorm(f[2]))
    return blended / wsum[:, None], (dist[:, 0] <= fmax) | (dist[:, 0]
                                                            <= 0.05)


def flow(pred: torch.Tensor, cano: torch.Tensor, anchors: torch.Tensor,
         flows: torch.Tensor, smooth: float = 1e-2) -> torch.Tensor:
    full = torch.cat([cano[None], pred], dim=0)           # canonical frame 0
    total = pred.new_zeros(())
    for t in range(pred.shape[0]):
        src = full[t]
        target, mask = blend_flow(src.detach(), anchors[t], flows[t])
        dy = full[t + 1] - src
        m = mask.to(dy.dtype)
        total = total + (m * ((dy - target) ** 2).sum(-1)
                         + smooth * (1.0 - m) * (dy ** 2).sum(-1)).sum()
    return total


class AssignInputs:
    """The assignment's FPS rows, worked out from the inputs: src (npoint,)
    rows of the canonical cloud, tgt (T-1, npoint, 3) the downsampled
    frames."""

    def __init__(self, cano: torch.Tensor, frames: torch.Tensor,
                 downsample: int):
        npoint = frames.shape[1] // downsample
        self.src = fps(cano[None], npoint)[0]
        idx = fps(frames, npoint)
        self.tgt = torch.gather(frames, 1, idx[..., None].expand(-1, -1, 3))


def step_loss(p: dict, cfg: dict, inputs: dict, gumbel, tau, perm=None,
              actx: AssignInputs | None = None) -> dict:
    """The loss terms of one step; `perm` in the assignment phase."""
    pred = forward(p, inputs["cano"], gumbel, tau)
    terms = {}
    if perm is None or cfg["always_recon"]:
        terms["recon"] = recon(pred, inputs["frames"])
    if perm is not None:
        src = pred[:, actx.src]
        matched = torch.gather(actx.tgt, 1, perm[..., None].expand(-1, -1, 3))
        terms["assign"] = cfg["lambda_assign"] * ((src - matched) ** 2).sum()
    if cfg["use_flow_loss"]:
        terms["flow"] = cfg["lambda_flow"] * flow(
            pred, inputs["cano"], inputs["anchors"], inputs["flows"])
    terms["total"] = sum(terms.values())
    return terms


def follow(p: dict, state: dict, cfg: dict, inputs: dict, gumbels: list,
           first_iter: int, assign: bool, workers: int = 1) -> dict:
    """len(gumbels) steps from weights `p` and Adam state `state`,
    starting at iteration `first_iter`, which in the assignment phase is a
    LAP boundary. A matching is solved exactly at every LAP boundary (each
    assign_gap iterations from assign_iter), on the predicted clouds of
    that step's draw and weights, in `workers` processes, and serves until
    the next. Returns {"losses": [float],
    "grad0": {leaf: tensor}, "weights": {leaf: tensor} after the last
    step}."""
    from reference import adam

    tf32_off()
    perm = actx = None
    if assign:
        actx = AssignInputs(inputs["cano"], inputs["frames"],
                            cfg["downsample"])
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    states = {k: adam.new_state(v, state.get(k)) for k, v in leaves.items()}
    groups = [([k for k in LEAVES if k in SEG_LEAVES], cfg["seg_lr"]),
              ([k for k in LEAVES if k not in SEG_LEAVES], cfg["trans_lr"])]
    losses, grad0 = [], None
    for j, g in enumerate(gumbels):
        it = first_iter + j
        tau = tau_at(it + 1, cfg)
        if assign and (it - cfg["assign_iter"]) % max(cfg["assign_gap"],
                                                      1) == 0:
            with torch.no_grad():
                pred = forward(leaves, inputs["cano"], g, tau)
                perm = torch.as_tensor(exact_matchings(
                    pred[:, actx.src].cpu().numpy(), actx.tgt.cpu().numpy(),
                    workers), device=pred.device)
        terms = step_loss(leaves, cfg, inputs, g, tau, perm, actx)
        grads = dict(zip(LEAVES, torch.autograd.grad(
            terms["total"], [leaves[k] for k in LEAVES])))
        losses.append(float(terms["total"].detach()))
        if grad0 is None:
            grad0 = grads
        for keys, lr in groups:
            adam.step([leaves[k] for k in keys], [grads[k] for k in keys],
                      [states[k] for k in keys], lr)
    return {"losses": losses, "grad0": grad0,
            "weights": {k: v.detach() for k, v in leaves.items()}}
