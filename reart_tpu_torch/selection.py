"""Energy-based canonical-frame and model selection (reart_tpu/selection.py).

`select_canonical_frame` fits the relaxation model once per candidate
canonical frame, one candidate after another on the run's device (or all
of them as one rows fit, parallel/rows.py), and keeps
the frame whose fit has the lowest selection energy (the ass + screw
[+ group] energy that finalize prints). `holdout_score` ranks a kinematic
tree by how well its screws, fitted on a subset of the frames, carry over
to the frames held out of that fit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reart_tpu_torch import resolve_device
from reart_tpu_torch.ik import _solve
from reart_tpu_torch.models.base_model import IDENTITY_6D
from reart_tpu_torch.models.kinematic import (
    PIN,
    KinematicModel,
    kinematic_forward,
)
from reart_tpu_torch.ops.distance import chamfer

# the per-frame rows of a KinematicModel (everything but the screw axes)
PER_FRAME_KEYS = ("theta_list", "distance_list", "root_6d", "root_t")


def holdout_split(t_fitted: int, every: int = 3):
    """Train/held split of the fitted frame indices: every `every`-th frame
    from 1 on is held out, so both subsets span the articulation range.
    Returns (train, held) int arrays."""
    held = np.arange(1, t_fitted, every)
    train = np.setdiff1d(np.arange(t_fitted), held)
    if held.size == 0 or train.size == 0:  # degenerate short sequences
        held = np.asarray([t_fitted - 1])
        train = np.arange(t_fitted - 1) if t_fitted > 1 else np.asarray([0])
    return train, held


def with_frames(params: KinematicModel, **rows) -> KinematicModel:
    """A new KinematicModel with the screws (axis_list, moment_list) of
    `params` and its per-frame rows replaced by `rows` (theta_list=...,
    ...); the rows not given are copied. `params` is left as it is."""
    values = {k: v.detach() for k, v in params.state_dict().items()}
    values.update(rows)
    theta = values["theta_list"]
    model = KinematicModel(theta.shape[0], theta.shape[1],
                           load_distance="distance_list" in values,
                           load_root_trans="root_6d" in values,
                           device=theta.device)
    model.load_state_dict(values)
    return model


def _holdout_chamfer(model, state, cano_pc, held_pc):
    pred, _, _ = kinematic_forward(model, state, cano_pc)
    return torch.mean(chamfer(pred, held_pc, bidirectional=True))


def _holdout_solve(params: KinematicModel, state, cano_pc, held_pc,
                   n_iter: int = 150, lr: float = 1e-1) -> float:
    """With the screws frozen, fit only per-held-frame joint coordinates
    (theta, prismatic distance, root pose) against the held-out clouds by
    AMSGrad (the inverse kinematics' optimiser), from the pinned start;
    return the final mean bidirectional Chamfer there."""
    h = held_pc.shape[0]
    e = params.theta_list.shape[1]
    dev = params.theta_list.device
    rows = {"theta_list": torch.full((h, e), PIN, device=dev)}
    if hasattr(params, "distance_list"):
        rows["distance_list"] = torch.full((h, e), PIN, device=dev)
    if hasattr(params, "root_6d"):
        rows["root_6d"] = torch.tensor(IDENTITY_6D, device=dev).repeat(h, 1)
        rows["root_t"] = torch.zeros((h, 3), device=dev)
    model = with_frames(params, **rows)
    model.axis_list.requires_grad_(False)
    model.moment_list.requires_grad_(False)
    opt = [getattr(model, k) for k in rows]
    _solve(lambda: _holdout_chamfer(model, state, cano_pc, held_pc), opt,
           n_iter, lr)
    with torch.no_grad():
        return float(_holdout_chamfer(model, state, cano_pc, held_pc))


def _interp_rows(train_vals: torch.Tensor, train_idx, held_idx):
    """Linear interpolation of per-frame rows at the held frame indices
    from the surrounding train frames (clamped at the ends), flattened to
    (H, -1)."""
    pos = np.interp(held_idx.astype(np.float64),
                    train_idx.astype(np.float64),
                    np.arange(len(train_idx), dtype=np.float64))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, len(train_idx) - 1)
    hi = np.clip(lo + 1, 0, len(train_idx) - 1)
    dev = train_vals.device
    w = torch.as_tensor((pos - lo)[:, None], dtype=train_vals.dtype,
                        device=dev)
    h = len(held_idx)
    lo_v = train_vals[torch.as_tensor(lo, device=dev)].reshape(h, -1)
    hi_v = train_vals[torch.as_tensor(hi, device=dev)].reshape(h, -1)
    return (1.0 - w) * lo_v + w * hi_v


@torch.no_grad()
def holdout_score_interp(params_fitted: KinematicModel, state, cano_pc,
                         pc_list, train, held) -> float:
    """Interpolated-coordinate holdout: each held frame's joint coordinates
    are the linear interpolation of the neighbouring train frames' fitted
    ones (no solve); the score is the mean reconstruction Chamfer there.
    Under the true topology joint coordinates vary smoothly over time; a
    wrong parent's coordinates absorb the parent's motion and interpolate
    badly."""
    h = len(held)
    rows = {}
    for k in PER_FRAME_KEYS:
        if hasattr(params_fitted, k):
            v = getattr(params_fitted, k).detach()
            rows[k] = _interp_rows(v, train, held).reshape(
                (h,) + tuple(v.shape[1:]))
    model = with_frames(params_fitted, **rows)
    pcs = torch.as_tensor(pc_list, dtype=torch.float32, device=cano_pc.device)
    return float(_holdout_chamfer(
        model, state, cano_pc,
        pcs[torch.as_tensor(np.asarray(held), device=pcs.device)]))


def holdout_score(params: KinematicModel, state, cfg, cano_pc, pc_list,
                  solve_iter: int = 150) -> float:
    """Held-out-frame score of one kinematic-tree candidate (lower is
    better): fit the candidate's screws on the train frames of
    `holdout_split` (no flow), then score the held frames twice, by the
    interpolated coordinates and by a free solve of their coordinates with
    the screws frozen, and return the sum. `params` (the candidate's
    initial model) is left as it is. cano_pc (N, 3), pc_list (T-1, N, 3):
    tensors on the fit's device."""
    from reart_tpu_torch.train import fit_kinematic

    train, held = holdout_split(pc_list.shape[0])
    dev = cano_pc.device
    train_t = torch.as_tensor(train, device=dev)
    train_model = with_frames(params, **{
        k: getattr(params, k).detach()[train_t] for k in PER_FRAME_KEYS
        if hasattr(params, k)})
    fitted, _ = fit_kinematic(train_model, state, cfg, pc_list[train_t],
                              flow_ctx=None, device=dev)
    solved = _holdout_solve(fitted, state, cano_pc,
                            pc_list[torch.as_tensor(held, device=dev)],
                            n_iter=solve_iter)
    interp = holdout_score_interp(fitted, state, cano_pc, pc_list, train,
                                  held)
    # the free solve cannot separate topologies (every tree reconstructs
    # single held clouds); the interpolated score carries the ranking and
    # the solve is a sanity floor in the sum
    return interp + solved


@torch.no_grad()
def fit_energy(cano_pc, pc_list, cano_idx: int, seg_part, trans_list,
               include_group: bool = True) -> dict:
    """Selection energy of a finished relaxation fit, with finalize's graph
    protocol: tiny parts reassigned, near-rigid parts merged, the MST,
    relabelled parts; a single part is a rigid fit with no tree. cano_pc
    (N, 3), pc_list (T-1, N, 3) and trans_list (T-1, P, 4, 4) tensors on
    one device, seg_part (N,) labels. Returns metrics.energy's dict."""
    from reart_tpu_torch.graph import (
        denoise_seg_label,
        extract_kinematic,
        merging_wrapper,
        mst_wrapper,
    )
    from reart_tpu_torch.metrics import energy
    from reart_tpu_torch.models.base_model import compute_pc_transform

    seg = denoise_seg_label(seg_part, cano_pc, min_num=20)
    if len(np.unique(seg)) > 1:
        seg = merging_wrapper(seg, trans_list, cano_pc, 3e-2)
    if len(np.unique(seg)) > 1:
        conn = mst_wrapper(seg, trans_list, cano_pc)
        seg, trans, conn = extract_kinematic(seg, trans_list, conn)
    else:  # degenerate single-part candidate: rigid fit, no tree
        lab = int(np.unique(seg)[0])
        seg = np.zeros_like(seg)
        trans = trans_list[:, lab:lab + 1]
        conn = np.zeros((0, 2), np.int64)
    pred_pc = compute_pc_transform(cano_pc, trans,
                                   torch.as_tensor(seg, device=cano_pc.device))
    complete_pred = torch.cat(
        [pred_pc[:cano_idx], cano_pc[None], pred_pc[cano_idx:]], 0)
    return energy(pred_pc, pc_list, trans, conn, seg,
                  complete_pred_pc_list=complete_pred,
                  include_group=include_group)


def select_canonical_frame(complete_pc_list, cfg, num_parts: int,
                           candidates=None, include_group: bool = True,
                           verbose: bool = True, seed: int = 0,
                           init_model=None, noise=None, batched: bool = False,
                           device=None):
    """Fit the relaxation model once per candidate canonical frame (every
    frame when `candidates` is None) and return (best_idx, {idx: energy
    dict}); the first of equal energies wins. complete_pc_list (T, N, 3).
    The fits carry no flow term (the selection criterion is the energy,
    which has none). With `batched` (the JAX package's mesh of more than
    one device) and more than one candidate, the candidates are fitted as
    one rows fit (parallel.fit_base_candidates) and then scored as the
    sequential loop scores them.

    Every candidate starts from the same parameters and draws, as the JAX
    package's one key gives them: `init_model()` -> a fresh BaseModel
    (default: seeded with `seed`, as the command line's), `noise(it)` ->
    the (N, P) Gumbel draw of iteration `it`, called from 0 for each
    candidate (default: a generator seeded with `seed` on the device, anew
    for each candidate). Runs on `device` (the card when None)."""
    from reart_tpu_torch.models.base_model import (
        BaseModel,
        base_forward,
        gumbel_noise,
    )
    from reart_tpu_torch.train import fit_base

    dev = resolve_device(device)
    complete = torch.as_tensor(np.asarray(complete_pc_list), device=dev,
                               dtype=torch.float32)
    t, n = complete.shape[:2]
    shape = (n, num_parts)
    if init_model is None:
        def init_model():
            return BaseModel(num_parts, t - 1, device=dev,
                             generator=torch.Generator().manual_seed(seed))

    candidates = [int(i) for i in (range(t) if candidates is None
                                   else candidates)]
    fits = None
    if batched and len(candidates) > 1:
        from reart_tpu_torch.parallel import fit_base_candidates

        if verbose:
            print(f"auto_cano sweep: {len(candidates)} candidates as one "
                  f"batch on {dev}", flush=True)
        fits = fit_base_candidates(cfg, complete, num_parts, candidates,
                                   seed=seed, init_model=init_model,
                                   noise=noise, device=dev)

    energies = {}
    for cano_idx in candidates:
        cano_pc = complete[cano_idx]
        pc_list = torch.cat([complete[:cano_idx], complete[cano_idx + 1:]])
        if fits is not None:
            _, seg, trans = fits[cano_idx]
        else:
            draw = noise
            if draw is None:
                gen = torch.Generator(device=dev).manual_seed(seed)

                def draw(_it, gen=gen):
                    return gumbel_noise(shape, gen, dev)

            fitted, _ = fit_base(init_model(),
                                 dataclasses.replace(cfg, cano_idx=cano_idx),
                                 cano_pc, pc_list, noise=draw, device=dev)
            with torch.no_grad():  # at tau 1 the labels are the argmax
                _, seg, trans = base_forward(
                    fitted, cano_pc, torch.zeros(shape, device=dev), 1.0)
        e = fit_energy(cano_pc, pc_list, cano_idx, seg.cpu().numpy(), trans,
                       include_group=include_group)
        energies[cano_idx] = e
        if verbose:
            print(f"cano {cano_idx}: total_err {e['total_err']:.3f}",
                  flush=True)
    best = min(energies, key=lambda i: energies[i]["total_err"])
    return best, energies
