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
the JAX engine does, so both packages can be handed the same draws.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from reart_tpu_torch import resolve_device
from reart_tpu_torch.losses import assignment_loss, flow_loss, recon_loss
from reart_tpu_torch.models.base_model import (
    BaseModel,
    base_forward,
    gumbel_noise,
)
from reart_tpu_torch.ops.assignment import auction_lap
from reart_tpu_torch.ops.distance import pairwise_sqdist
from reart_tpu_torch.ops.interpolate import blend_anchor_motion_batched
from reart_tpu_torch.ops.sampling import farthest_point_sample, index_points
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
    the downsampled target frames."""

    src_idx: torch.Tensor
    pc_tgt: torch.Tensor


def build_assign_context(cano_pc: torch.Tensor, pc_list: torch.Tensor,
                         downsample: int) -> AssignContext:
    num_fps = pc_list.shape[1] // downsample
    src_idx = farthest_point_sample(cano_pc[None], num_fps)[0]
    tgt_idx = farthest_point_sample(pc_list, num_fps)
    return AssignContext(src_idx, index_points(pc_list, tgt_idx))


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
              cano_idx: int) -> torch.Tensor:
    """Re-insert the canonical frame at its original position."""
    return torch.cat([pc_trans_list[:cano_idx], cano_pc[None],
                      pc_trans_list[cano_idx:]], dim=0)


def _flow_term(pc_trans_list, cano_pc, flow_ctx: FlowContext,
               cfg: FitConfig):
    """Blend the anchor flows onto the predicted source points (no grad) and
    apply the masked flow loss."""
    complete_pred = _complete(pc_trans_list, cano_pc, cfg.cano_idx)
    blended, mask = blend_anchor_motion_batched(
        complete_pred[:-1].detach(), flow_ctx.pc_ref, flow_ctx.flow_ref)
    pred_flow = complete_pred[1:] - complete_pred[:-1]
    return cfg.lambda_flow * flow_loss(blended, pred_flow,
                                       flow_mask_list=mask,
                                       robust=cfg.use_robust_loss)


def fit(forward_fn: ForwardFn, model: torch.nn.Module, cfg: FitConfig,
        cano_pc: torch.Tensor, pc_list: torch.Tensor,
        noise: Callable[[int], torch.Tensor],
        flow_ctx: FlowContext | None = None, two_group_opt: bool = False):
    """Run the fit in place on `model`. Returns (model, history): history
    maps total_loss, recon_loss, ass_loss and flow_loss to (n_iter,)
    float32 tensors on the model's device, zeros where a term is inactive.
    `noise(it)` is called once per iteration, in order."""
    dev = cano_pc.device
    opt = make_optimizer(model, cfg, two_groups=two_group_opt)
    tau_fn = functools.partial(tau_cosine, max_iter=cfg.n_iter,
                               end_temp=cfg.end_tau, start_temp=cfg.start_tau)
    history = {k: torch.zeros(cfg.n_iter, dtype=torch.float32, device=dev)
               for k in HISTORY_KEYS}

    def draw(it):
        return torch.as_tensor(noise(it), dtype=torch.float32, device=dev)

    def step(it, g, perm=None, actx=None):
        pc_trans_list, _, _ = forward_fn(model, cano_pc, g, tau_fn(it + 1))
        terms = {}
        if perm is None or cfg.always_recon:
            terms["recon_loss"] = recon_loss(pc_trans_list, pc_list)
        if perm is not None:
            terms["ass_loss"] = cfg.lambda_assign * assignment_loss(
                pc_trans_list[:, actx.src_idx], actx.pc_tgt, perm)
        if flow_ctx is not None and cfg.use_flow_loss:
            terms["flow_loss"] = _flow_term(pc_trans_list, cano_pc, flow_ctx,
                                            cfg)
        total = functools.reduce(torch.add, terms.values())
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        terms["total_loss"] = total
        for k, v in terms.items():
            history[k][it] = v.detach()

    use_assign = cfg.use_assign_loss and cfg.assign_iter < cfg.n_iter
    n_recon = min(cfg.assign_iter, cfg.n_iter) if use_assign else cfg.n_iter
    for it in range(n_recon):
        step(it, draw(it))

    if use_assign:
        actx = build_assign_context(cano_pc, pc_list, cfg.downsample)
        price = torch.zeros(actx.pc_tgt.shape[:2], dtype=torch.float32,
                            device=dev)
        gap = max(1, cfg.assign_gap)
        for it0 in range(n_recon, cfg.n_iter, gap):
            g0 = draw(it0)
            with torch.no_grad():
                pc_trans_list, _, _ = forward_fn(model, cano_pc, g0,
                                                 tau_fn(it0 + 1))
                pc_src = pc_trans_list[:, actx.src_idx]
                cost = torch.sqrt(pairwise_sqdist(pc_src, actx.pc_tgt))
                # warm-started prices: between solves the clouds barely
                # move, so a solve converges in a few bounded sweeps
                perm, price = auction_lap(
                    cost, eps_min=1e-4, num_scales=2, scale_factor=50.0,
                    max_sweeps=cfg.assign_sweeps, price=price,
                    return_price=True)
            for it in range(it0, min(it0 + gap, cfg.n_iter)):
                step(it, g0 if it == it0 else draw(it), perm, actx)
    return model, history


def fit_base(params: BaseModel, cfg: FitConfig, cano_pc, pc_list,
             flow_ctx: FlowContext | None = None,
             noise: Callable[[int], torch.Tensor] | None = None,
             device=None):
    """Relaxation-stage fit (reference `--model=base`).

    params: the BaseModel, trained in place after a move to `device` (the
    card when None; `device="cpu"` runs the plain versions on the CPU).
    cano_pc (N, 3) and pc_list (T-1, N, 3): arrays or tensors. noise(it) ->
    (N, P) Gumbel draw; by default drawn from a torch.Generator seeded with
    0 on the device. Returns (params, history)."""
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
               flow_ctx=flow_ctx, two_group_opt=True)
