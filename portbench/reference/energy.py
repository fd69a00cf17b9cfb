"""The plain reference of the robot selection energy's assignment and group
terms (stevenlsw/reart's `energy` with the group term), from the inputs and
a run's final segmentation and poses.

  pred_t     the canonical cloud carried by each point's part pose, frame t
             (the configurations' blend of the part transforms, in float32
             on the card: torch's einsums, as the forward states it)
  ass_err    100 x the mean over frames of the mean squared distance of
             the exact minimum summed euclidean distance matching between
             pred_t and the observed frame t (scipy's linear_sum_assignment
             on the float32 distances, (dx^2 + dy^2) + dz^2 then the root,
             and the squared distances summed in float32)
  group_err  the largest over parts of the mean squared distance of a
             part's points to its centroid, over every frame with the
             canonical one (float64)

Nothing of the program is imported. The frames' matchings are independent
and may be solved in parallel processes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from reference.ops import exact_matchings


def predicted(cano, seg, poses, device) -> np.ndarray:
    """cano (N, 3), seg (N,), poses (T, P, 4, 4) -> (T, N, 3) float32."""
    cano = torch.as_tensor(np.asarray(cano, np.float32), device=device)
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    w = F.one_hot(torch.as_tensor(np.asarray(seg), device=device).long(),
                  poses.shape[1]).to(torch.float32)
    blended = torch.einsum("np,tpij->tnij", w, poses[..., :3, :])
    xh = torch.cat([cano, torch.ones_like(cano[:, :1])], dim=-1)
    return torch.einsum("tnij,nj->tni", blended, xh).cpu().numpy()


def selection_energy(cano, pc_list, seg, poses, device=None,
                     workers: int = 1) -> dict:
    """-> {"ass_err", "group_err"}; the frames' exact matchings are solved
    in `workers` processes (spawned, and ended before this returns)."""
    pred = predicted(cano, seg, poses, device)
    obs = np.asarray(pc_list, np.float32)
    perms = exact_matchings(pred, obs, workers)
    matched = np.take_along_axis(obs, perms[..., None], axis=1)
    sq = ((pred - matched) ** 2).sum(-1).sum(-1)            # (T,) float32
    ass = float(sq.mean() / pred.shape[1])
    seg = np.asarray(seg).astype(np.int64)
    full = np.concatenate([np.asarray(cano, np.float64)[None],
                           pred.astype(np.float64)], axis=0)
    group = -np.inf
    for p in np.unique(seg):
        pts = full[:, seg == p]                              # (T, n_p, 3)
        spread = ((pts - pts.mean(1, keepdims=True)) ** 2).sum(-1)
        group = max(group, spread.sum() / (pts.shape[1] * full.shape[0]))
    return {"ass_err": 100.0 * ass, "group_err": float(group)}
