"""The fit engine (reart_tpu/train/engine.py): per-sequence optimisation as
a plain Python loop of exactly `n_iter` Adam steps.

The relaxation fit runs a recon(+flow) phase, then an assignment(+flow)
phase. Every `assign_gap` iterations of the second phase one LAP is solved
on the current predicted clouds, with auction prices warm-started from the
previous solve; the flow term blends anchor flows onto the predicted
points without gradient.

Randomness is injected: `noise(it)` returns the (N, P) Gumbel draw of
iteration `it`. The LAP forward at a chunk start `it0` reuses the draw of
iteration `it0` with tau(it0 + 1), on the parameters before that step, as
the JAX engine does, so both packages can be handed the same draws. The
projection ("kinematic") fit runs the same loop on a KinematicModel with
one Adam group and draws no noise.

A LAP past 1024^2 on the card takes the banded points-level solve
(ops/assignment.auction_lap_points) where `assign_band` admits it. In auto
mode (-1) a quality guard solves the first problem banded and dense and
keeps the band only if its matched cost is within `assign_band_guard`; it
probes again every `assign_band_reprobe` iterations, at a LAP boundary, on
that LAP's own clouds (the JAX engine probes on a forward with its base
key; here the draw of that LAP's iteration). On the CPU every size goes
dense.

With `checkpoint_dir` the fit leaves `fit_state.pkl` there every
`checkpoint_every` iterations (parameters, optimizer state, prices,
history, the guard's decision) and the next call resumes from it; the file
goes when the fit completes. There are no dispatch chunks: a log line, a
snapshot or a save falls on the first iteration boundary (in the
assignment phase: the first LAP boundary) at or past each multiple.

With tracing on (profiling.py) each iteration is the span `fit.iteration`
(children `fit.forward`, `fit.loss`, `fit.backward`, `fit.update`) and is
counted in `fit.iterations`; each LAP boundary is `fit.lap` (children
`fit.lap.forward`, `fit.lap.probe` where the band guard probes,
`fit.lap.solve`, whose solvers count their routes, sweeps and rows left
at the sweep bound: ops/assignment); a log, snapshot or save is
`fit.boundary`.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Callable, NamedTuple

import numpy as np
import torch

from reart_tpu_torch import resolve_device, tree_to_numpy
from reart_tpu_torch.losses import assignment_loss, flow_loss, recon_loss
from reart_tpu_torch.models.base_model import (
    BaseModel,
    base_forward,
    gumbel_noise,
)
from reart_tpu_torch.models.kinematic import (
    KinematicModel,
    KinematicState,
    kinematic_forward,
)
from reart_tpu_torch.ops import assignment
from reart_tpu_torch.ops.assignment import auction_lap
from reart_tpu_torch.ops.distance import pairwise_sqdist
from reart_tpu_torch.ops.interpolate import blend_anchor_motion_batched
from reart_tpu_torch.ops.sampling import farthest_point_sample, index_points
from reart_tpu_torch.profiling import count, span
from reart_tpu_torch.train.schedules import tau_cosine

# sentinel coordinate for padded flow anchors: a padded anchor can never
# enter a real point's 3-NN set
FAR = 1e6

HISTORY_KEYS = ("total_loss", "recon_loss", "ass_loss", "flow_loss")

ForwardFn = Callable[..., tuple]
# (model, cano_pc, noise (N, P), tau) -> (pc_trans_list, seg, trans_list)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """The reference's fit flags (defaults: robot relaxation)."""

    n_iter: int = 15000
    # losses
    use_assign_loss: bool = False
    use_flow_loss: bool = False
    use_robust_loss: bool = False
    always_recon: bool = False        # sapien: recon stays on in phase 2
    assign_iter: int = 5000           # first iteration of the assignment phase
    assign_gap: int = 5               # LAP recompute cadence
    downsample: int = 4               # FPS downsample for the assignment cost
    # loss weights
    lambda_assign: float = 3e-1
    lambda_flow: float = 1.0
    # gumbel temperature schedule
    start_tau: float = 5.0
    end_tau: float = 1.0
    # optimizer
    seg_lr: float = 1e-3
    trans_lr: float = 1e-2
    weight_decay: float = 0.0
    cano_idx: int = 0
    # auction sweep bound per epsilon phase
    assign_sweeps: int = 100
    # column window of the banded points-level LAP for problems past 1024^2
    # on the card: -1 scales it with the problem, 0 takes the dense path
    assign_band: int = -1
    # auto mode only: solve the first real problem banded and dense and keep
    # the band only if its matched cost is at most this fraction worse
    # (0 disables the guard)
    assign_band_guard: float = 0.05
    # re-run that probe every this many assignment-phase iterations, so a
    # fit whose clouds align as it converges can switch back (0 = once)
    assign_band_reprobe: int = 1000


class FlowContext(NamedTuple):
    """Flow supervision for consecutive frame pairs: pc_ref / flow_ref
    (T-1, M, 3) anchors of each pair's source frame and their flows, padded
    to a common M with FAR points and zero flow (>= 3 real anchors each)."""

    pc_ref: torch.Tensor
    flow_ref: torch.Tensor

    @staticmethod
    def from_lists(pc_refs, flow_refs, device=None) -> "FlowContext":
        """Pad per-pair anchor lists (numpy or tensors) to one shape."""
        pc_refs = [np.asarray(p, np.float32) for p in pc_refs]
        flow_refs = [np.asarray(f, np.float32) for f in flow_refs]
        m = max(p.shape[0] for p in pc_refs)
        t = len(pc_refs)
        pc = np.full((t, m, 3), FAR, dtype=np.float32)
        fl = np.zeros((t, m, 3), dtype=np.float32)
        for i, (p, f) in enumerate(zip(pc_refs, flow_refs)):
            pc[i, : p.shape[0]] = p
            fl[i, : f.shape[0]] = f
        return FlowContext(torch.as_tensor(pc, device=device),
                           torch.as_tensor(fl, device=device))

    def to(self, device) -> "FlowContext":
        return FlowContext(self.pc_ref.to(device), self.flow_ref.to(device))


class AssignContext(NamedTuple):
    """FPS downsampling for the assignment loss, computed once per fit:
    src_idx (num_fps,) rows of the canonical cloud, pc_tgt (T-1, num_fps, 3)
    the downsampled target frames. A rows fit holds src_idx (C, num_fps),
    each row's own, and pc_tgt (C * (T-1), num_fps, 3), its frames folded
    into the batch axis."""

    src_idx: torch.Tensor
    pc_tgt: torch.Tensor


def build_assign_context(cano_pc: torch.Tensor, pc_list: torch.Tensor,
                         downsample: int) -> AssignContext:
    """cano_pc (N, 3) and pc_list (T-1, N, 3); or C rows of each, (C, N, 3)
    and (C, T-1, N, 3): one FPS launch for the C canonical clouds and one
    for the C * (T-1) frames."""
    num_fps = pc_list.shape[-2] // downsample
    if cano_pc.dim() == 2:
        src_idx = farthest_point_sample(cano_pc[None], num_fps)[0]
    else:
        src_idx = farthest_point_sample(cano_pc, num_fps)
    frames = pc_list.reshape((-1,) + pc_list.shape[-2:])
    tgt_idx = farthest_point_sample(frames, num_fps)
    return AssignContext(src_idx, index_points(frames, tgt_idx))


def select_rows(actx: AssignContext, pc_trans_list: torch.Tensor):
    """The assignment's source points: (T-1, N, 3) -> (T-1, num_fps, 3);
    for C rows (C, T-1, N, 3) -> (C * (T-1), num_fps, 3), each row's own
    FPS rows."""
    if pc_trans_list.dim() == 3:
        return pc_trans_list[:, actx.src_idx]
    c, t, _, _ = pc_trans_list.shape
    idx = actx.src_idx[:, None, :, None].expand(c, t, -1, 3)
    return torch.gather(pc_trans_list, 2, idx).reshape(c * t, -1, 3)


def make_optimizer(model: torch.nn.Module, cfg: FitConfig,
                   two_groups: bool) -> torch.optim.Adam:
    """Adam with the reference's groups: the seg MLP at seg_lr, the
    proposals at trans_lr; one group at trans_lr otherwise. weight_decay is
    added to the gradient (L2), as optax's add_decayed_weights does."""
    if not two_groups:
        return torch.optim.Adam(model.parameters(), lr=cfg.trans_lr,
                                weight_decay=cfg.weight_decay)
    seg = [p for n, p in model.named_parameters() if n.startswith("seg.")]
    trans = [p for n, p in model.named_parameters()
             if not n.startswith("seg.")]
    return torch.optim.Adam(
        [{"params": seg, "lr": cfg.seg_lr},
         {"params": trans, "lr": cfg.trans_lr}],
        weight_decay=cfg.weight_decay)


def _complete(pc_trans_list: torch.Tensor, cano_pc: torch.Tensor,
              cano_idx) -> torch.Tensor:
    """Re-insert the canonical frame at its original position: (T-1, N, 3)
    and (N, 3) at an int cano_idx -> (T, N, 3); C rows (C, T-1, N, 3) and
    (C, N, 3), each at its own cano_idx[c] ((C,) int64) -> (C, T, N, 3)."""
    if pc_trans_list.dim() == 3:
        return torch.cat([pc_trans_list[:cano_idx], cano_pc[None],
                          pc_trans_list[cano_idx:]], dim=0)
    c, tm1, n, _ = pc_trans_list.shape
    both = torch.cat([pc_trans_list, cano_pc[:, None]], dim=1)
    t = torch.arange(tm1 + 1, device=both.device)[None]
    k = cano_idx[:, None]
    src = torch.where(t < k, t, torch.where(t == k, tm1, t - 1))
    return torch.gather(both, 1, src[:, :, None, None].expand(c, -1, n, 3))


def _flow_term(pc_trans_list, cano_pc, flow_ctx: FlowContext,
               cfg: FitConfig, cano_idx):
    """Blend the anchor flows onto the predicted source points (no grad) and
    apply the masked flow loss; C rows fold their frames into the batch."""
    complete_pred = _complete(pc_trans_list, cano_pc, cano_idx)

    def fold(x):
        return x.reshape((-1,) + x.shape[-2:])

    src = fold(complete_pred[..., :-1, :, :])
    blended, mask = blend_anchor_motion_batched(
        src.detach(), fold(flow_ctx.pc_ref), fold(flow_ctx.flow_ref))
    pred_flow = fold(complete_pred[..., 1:, :, :]) - src
    return cfg.lambda_flow * flow_loss(blended, pred_flow,
                                       flow_mask_list=mask,
                                       robust=cfg.use_robust_loss)


def _to_device(value, dev):
    """Inverse of tree_to_numpy. Scalars (Adam's step counts) stay on the
    CPU, where the optimizer keeps them."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=dev if value.ndim else "cpu")
    if isinstance(value, dict):
        return {k: _to_device(v, dev) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_device(v, dev) for v in value]
    return value


def fit(forward_fn: ForwardFn, model: torch.nn.Module, cfg: FitConfig,
        cano_pc: torch.Tensor, pc_list: torch.Tensor,
        noise: Callable[[int], torch.Tensor] | None,
        flow_ctx: FlowContext | None = None, two_group_opt: bool = False,
        log_every: int | None = None, checkpoint_dir: str | None = None,
        checkpoint_every: int = 2000, snapshot_cb=None,
        snapshot_every: int | None = None, cano_idx=None):
    """Run the fit in place on `model`. Returns (model, history): history
    maps total_loss, recon_loss, ass_loss and flow_loss to (n_iter,)
    float32 tensors on the model's device, zeros where a term is inactive.
    `noise(it)` is called once per iteration, in order (a resumed fit calls
    it for the iterations already done too and drops those draws, so a
    stateful generator stays in step); None for a forward without noise.

    log_every: print the last iteration's terms each time the count of
    iterations done crosses a multiple (one read-back per print).
    snapshot_cb(done, model): called under the same rule at multiples of
    snapshot_every, never after the last iteration.
    checkpoint_dir: resume from `fit_state.pkl` there when it exists, save
    to it (atomically) every checkpoint_every iterations, remove it when
    the fit completes.

    Rows: with cano_pc (C, N, 3) and pc_list (C, T-1, N, 3) the model is a
    rows model (parallel.BaseRows) and C independent fits run as one: their
    frames fold into the kernels' batch axis and the summed loss gives each
    row its own gradient. `cano_idx` holds each row's canonical frame (C
    ints; cfg.cano_idx for every row when None) and history the rows'
    sums. As the JAX package's rows fit, every LAP past 1024^2 that the
    banded solve admits takes it, with no band guard and no re-probe, and
    there is no checkpoint, resume or snapshot."""
    dev = cano_pc.device
    rows = cano_pc.dim() == 3
    if rows:
        if checkpoint_dir is not None or snapshot_cb is not None:
            raise ValueError("a rows fit takes no checkpoint_dir and no "
                             "snapshot_cb")
        cano_idx = torch.as_tensor(
            [cfg.cano_idx] * cano_pc.shape[0] if cano_idx is None
            else cano_idx, dtype=torch.int64, device=dev)
    elif cano_idx is None:
        cano_idx = cfg.cano_idx
    opt = make_optimizer(model, cfg, two_groups=two_group_opt)
    tau_fn = functools.partial(tau_cosine, max_iter=cfg.n_iter,
                               end_temp=cfg.end_tau, start_temp=cfg.start_tau)
    history = {k: torch.zeros(cfg.n_iter, dtype=torch.float32, device=dev)
               for k in HISTORY_KEYS}
    ckpt_path = (os.path.join(checkpoint_dir, "fit_state.pkl")
                 if checkpoint_dir else None)
    resume_done = 0
    price = None
    # the band guard's decision (None until made): a resumed fit reuses it
    guard = {"band": None}
    if ckpt_path is not None and os.path.exists(ckpt_path):
        with open(ckpt_path, "rb") as f:
            saved = pickle.load(f)
        resume_done = int(saved["done"])
        model.load_state_dict(_to_device(saved["params"], dev))
        opt.load_state_dict(_to_device(saved["opt_state"], dev))
        if saved["price"] is not None:
            price = torch.as_tensor(saved["price"], device=dev)
        for k, v in saved["history"].items():
            history[k][:resume_done] = torch.as_tensor(v, device=dev)
        guard["band"] = saved.get("guard_band")
        print(f"[fit] resuming from iteration {resume_done}", flush=True)
        if noise is not None:
            for it in range(resume_done):
                noise(it)
    last_saved = resume_done

    def draw(it):
        if noise is None:
            return None
        return torch.as_tensor(noise(it), dtype=torch.float32, device=dev)

    def boundary(done, step_sz):
        """After `step_sz` more iterations, `done` in all: log, snapshot
        and save where a multiple was crossed."""
        nonlocal last_saved

        def crossed(every):
            return done // every != (done - step_sz) // every

        log = log_every is not None and (crossed(max(log_every, 1))
                                         or done >= cfg.n_iter)
        snap = (snapshot_cb is not None and done < cfg.n_iter
                and crossed(max(snapshot_every or cfg.n_iter, 1)))
        save = (ckpt_path is not None and done < cfg.n_iter
                and done - last_saved >= checkpoint_every)
        if not (log or snap or save):
            return
        with span("fit.boundary", dev):
            if log:
                last = {k: float(history[k][done - 1]) for k in HISTORY_KEYS}
                msg = " | ".join(f"{k}: {v:.3f}" for k, v in last.items()
                                 if v != 0.0)
                print(f"iteration {done - 1} | {msg}", flush=True)
            if snap:
                snapshot_cb(done, model)
            if save:
                os.makedirs(checkpoint_dir, exist_ok=True)
                payload = {
                    "done": done,
                    "params": tree_to_numpy(dict(model.state_dict())),
                    "opt_state": tree_to_numpy(opt.state_dict()),
                    "price": None if price is None else tree_to_numpy(price),
                    "history": {k: tree_to_numpy(v[:done])
                                for k, v in history.items()},
                    "guard_band": guard["band"],
                }
                tmp = ckpt_path + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(payload, f)
                os.replace(tmp, ckpt_path)  # atomic: never half a file
                last_saved = done

    def step(it, g, perm=None, actx=None):
        with span("fit.iteration", dev):
            with span("fit.forward", dev):
                pc_trans_list, _, _ = forward_fn(model, cano_pc, g,
                                                 tau_fn(it + 1))
            with span("fit.loss", dev):
                terms = {}
                if perm is None or cfg.always_recon:
                    terms["recon_loss"] = recon_loss(pc_trans_list, pc_list)
                if perm is not None:
                    terms["ass_loss"] = cfg.lambda_assign * assignment_loss(
                        select_rows(actx, pc_trans_list), actx.pc_tgt, perm)
                if flow_ctx is not None and cfg.use_flow_loss:
                    terms["flow_loss"] = _flow_term(pc_trans_list, cano_pc,
                                                    flow_ctx, cfg, cano_idx)
                total = functools.reduce(torch.add, terms.values())
            with span("fit.backward", dev):
                opt.zero_grad(set_to_none=True)
                total.backward()
            with span("fit.update", dev):
                opt.step()
                terms["total_loss"] = total
                for k, v in terms.items():
                    history[k][it] = v.detach()
        count("fit.iterations")

    use_assign = cfg.use_assign_loss and cfg.assign_iter < cfg.n_iter
    n_recon = min(cfg.assign_iter, cfg.n_iter) if use_assign else cfg.n_iter
    for it in range(resume_done, n_recon):
        step(it, draw(it))
        boundary(it + 1, 1)

    if use_assign:
        actx = build_assign_context(cano_pc, pc_list, cfg.downsample)
        num_fps = actx.pc_tgt.shape[1]
        if price is None:
            price = torch.zeros(actx.pc_tgt.shape[:2], dtype=torch.float32,
                                device=dev)
        band = assignment.resolve_band(cfg.assign_band, num_fps)
        guard_active = (not rows and cfg.assign_band == -1
                        and cfg.assign_band_guard > 0
                        and assignment.banded_points_available(
                            num_fps, num_fps, band, dev))
        gap = max(1, cfg.assign_gap)
        rp = max(cfg.assign_band_reprobe, 0)

        def probe(pc_src, price):
            with span("fit.lap.probe", dev):
                cb, cd = _band_guard_probe(pc_src, actx.pc_tgt, price, band,
                                           cfg.assign_sweeps)
            rel = cb / max(cd, 1e-12) - 1.0
            return (band if rel <= cfg.assign_band_guard else 0), rel

        # a save falls on a LAP boundary, so a resumed fit starts on one
        for it0 in range(max(n_recon, resume_done), cfg.n_iter, gap):
            g0 = draw(it0)
            with torch.no_grad(), span("fit.lap", dev):
                with span("fit.lap.forward", dev):
                    pc_trans_list, _, _ = forward_fn(model, cano_pc, g0,
                                                     tau_fn(it0 + 1))
                    pc_src = select_rows(actx, pc_trans_list)
                if guard_active and guard["band"] is None:
                    guard["band"], rel = probe(pc_src, price)
                    if guard["band"] == 0:
                        print(f"[fit] banded-LAP guard: banded matched cost "
                              f"{rel:+.1%} vs dense on the first-solve "
                              f"clouds (> +{cfg.assign_band_guard:.0%}) — "
                              f"dense solver", flush=True)
                elif (guard_active and rp > 0 and it0 > n_recon
                      and (it0 - n_recon) // rp
                      != (it0 - n_recon - gap) // rp):
                    # the mid-fit re-probe: clouds often align as the fit
                    # converges, when the band becomes safe again
                    new_band, rel = probe(pc_src, price)
                    if new_band != guard["band"]:
                        which = "banded" if new_band else "dense"
                        print(f"[fit] banded-LAP guard re-probe at iteration "
                              f"{it0}: matched cost {rel:+.1%} vs dense — "
                              f"switching to the {which} solver", flush=True)
                        guard["band"] = new_band
                # warm-started prices: between solves the clouds barely
                # move, so a solve converges in a few bounded sweeps
                with span("fit.lap.solve", dev):
                    perm, price = _solve_assignment(
                        pc_src, actx.pc_tgt, price,
                        guard["band"] if guard_active else band,
                        cfg.assign_sweeps)
            end = min(it0 + gap, cfg.n_iter)
            for it in range(it0, end):
                step(it, g0 if it == it0 else draw(it), perm, actx)
            boundary(end, end - it0)
    if ckpt_path is not None and os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # the fit completed: nothing to resume
    return model, history


def _solve_assignment(pc_src, pc_tgt, price, band: int, sweeps: int):
    """One LAP of the assignment phase, warm-started from `price`: the
    banded points-level solve where `band` admits it on this device (never
    on the CPU), else the dense auction of the distance matrix."""
    n, m = pc_src.shape[1], pc_tgt.shape[1]
    if assignment.banded_points_available(n, m, band, pc_src.device):
        return assignment.auction_lap_points(
            pc_src, pc_tgt, band=band, eps_min=1e-4, num_scales=2,
            scale_factor=50.0, max_sweeps=sweeps, price=price,
            return_price=True)
    cost = torch.sqrt(pairwise_sqdist(pc_src, pc_tgt))
    return auction_lap(cost, eps_min=1e-4, num_scales=2, scale_factor=50.0,
                       max_sweeps=sweeps, price=price, return_price=True)


def _band_guard_probe(pc_src, pc_tgt, price, band: int, sweeps: int):
    """The band guard's evidence: the same assignment problem solved banded
    and dense (warm from the same prices), each matching's summed euclidean
    cost -> (banded, dense) floats. The dense (B, N, M) cost matrix is built
    once here. On aligned clouds the banded matching is as close to the
    optimum as the dense sweep-bounded one; where the clouds' curve orders
    disagree it is far worse, which is what this measures."""
    r2c_b = assignment.auction_lap_points(
        pc_src, pc_tgt, band=band, eps_min=1e-4, num_scales=2,
        scale_factor=50.0, max_sweeps=sweeps, price=price)
    cost = torch.sqrt(pairwise_sqdist(pc_src, pc_tgt))
    r2c_d = auction_lap(cost, eps_min=1e-4, num_scales=2, scale_factor=50.0,
                        max_sweeps=sweeps, price=price)

    def matched(r2c):
        tgt = torch.gather(pc_tgt, 1, r2c[..., None].expand(-1, -1, 3))
        return float(torch.linalg.norm(pc_src - tgt, dim=-1).sum())

    return matched(r2c_b), matched(r2c_d)


def fit_base(params: BaseModel, cfg: FitConfig, cano_pc, pc_list,
             flow_ctx: FlowContext | None = None,
             noise: Callable[[int], torch.Tensor] | None = None,
             device=None, **fit_kw):
    """Relaxation-stage fit (reference `--model=base`).

    params: the BaseModel, trained in place after a move to `device` (the
    card when None; `device="cpu"` runs the plain versions on the CPU).
    cano_pc (N, 3) and pc_list (T-1, N, 3): arrays or tensors. noise(it) ->
    (N, P) Gumbel draw; by default drawn from a torch.Generator seeded with
    0 on the device. `fit_kw`: log_every, checkpoint_dir, checkpoint_every,
    snapshot_cb, snapshot_every of `fit`. Returns (params, history)."""
    device = resolve_device(device)
    params = params.to(device)
    cano = torch.as_tensor(cano_pc, dtype=torch.float32, device=device)
    pcs = torch.as_tensor(pc_list, dtype=torch.float32, device=device)
    if flow_ctx is not None:
        flow_ctx = flow_ctx.to(device)
    if noise is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        shape = (cano.shape[0], params.num_parts)

        def noise(_it):
            return gumbel_noise(shape, gen, device)

    return fit(base_forward, params, cfg, cano, pcs, noise,
               flow_ctx=flow_ctx, two_group_opt=True, **fit_kw)


def _kinematic_forward_fn(model: KinematicModel, cano_pc, _noise, _tau, *,
                          state: KinematicState):
    """The fit always forwards the canonical cloud, where the 1-NN label
    transfer is the identity: the state's own labels are passed."""
    return kinematic_forward(model, state, cano_pc, seg_part=state.seg_part)


def fit_kinematic(params: KinematicModel, state: KinematicState,
                  cfg: FitConfig, pc_list,
                  flow_ctx: FlowContext | None = None, device=None,
                  **fit_kw):
    """Projection-stage fit (reference `--model=kinematic`): the same loss
    stack as the relaxation fit, one Adam group over all parameters at
    trans_lr, no Gumbel noise.

    params and state are moved to `device` (the card when None); the model
    is trained in place. pc_list (T-1, N, 3): array or tensor. `fit_kw` as
    for `fit_base`. Returns (params, history)."""
    device = resolve_device(device)
    params = params.to(device)
    state = state.to(device)
    pcs = torch.as_tensor(pc_list, dtype=torch.float32, device=device)
    if flow_ctx is not None:
        flow_ctx = flow_ctx.to(device)
    forward_fn = functools.partial(_kinematic_forward_fn, state=state)
    return fit(forward_fn, params, cfg, state.cano_pc, pcs, None,
               flow_ctx=flow_ctx, two_group_opt=False, **fit_kw)
