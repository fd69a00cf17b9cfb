"""Batched fits on one card (reart_tpu/parallel/mesh.py).

The JAX package lays independent fits on a device mesh ("seq" axis) and
vmaps the per-sequence programs over them. Here the rows share one device:
C relaxation models are stacked on a leading axis (`BaseRows`), their
frames fold into the kernels' batch axis (C * (T-1) frames for the Chamfer,
the flow blend and the LAP, C canonical clouds for FPS), and the summed
loss gives each row the gradient of its own. The small dense forward (the
seg MLP, the blended transforms) runs row by row through base_forward's
own calls, so that a row equals its sequential fit bit for bit. Adam is
elementwise, so one optimizer over the stacked parameters updates each row
as a separate one would.

  * `fit_base_sequences`: different sequences of one shape, one canonical
    frame (the `--batch_seq` sapien sweep);
  * `fit_base_candidates`: one sequence, one row per candidate canonical
    frame (the batched `--auto_cano` sweep);
  * `fit_batch` / `make_batched_fit_step`: a plain Chamfer (+ cold
    auction) step over a batch of sequences, per-row draws and losses.

Every row of the first two starts from the same parameters and gets the
same Gumbel draw each iteration, as the JAX package's one key gives them,
so row i computes the sequential `fit_base` of row i. The mesh plumbing
(`make_mesh`, `batch_spec`, `replicated_spec`) has no counterpart: there is
one card and no collective.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from reart_tpu_torch import resolve_device, to_numpy
from reart_tpu_torch.models.base_model import (
    BaseModel,
    base_forward,
    gumbel_noise,
)
from reart_tpu_torch.models.blocks import mlp_apply


class RowsSeg(nn.Module):
    """C per-point seg MLPs stacked on a leading axis: weight[j] (C, out,
    in) of layer j, bias[j] (C, out) of every layer but the last."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]):
        super().__init__()
        self.weight = nn.ParameterList(nn.Parameter(w) for w in weights)
        self.bias = nn.ParameterList(nn.Parameter(b) for b in biases)

    def row(self, i: int):
        """Row i's MLP as a function of the points (views of the stacked
        parameters, so its gradients reach them)."""
        weights = [w[i] for w in self.weight]
        biases = [b[i] for b in self.bias] + [None]
        return lambda x: mlp_apply(x, weights, biases)


class _RowView(NamedTuple):
    """What base_forward reads of a model, for one row of a BaseRows."""

    seg: Callable
    proposal_6d: torch.Tensor
    proposal_t: torch.Tensor


class BaseRows(nn.Module):
    """C relaxation models as one module: `seg` (a RowsSeg), proposal_6d
    (C, T-1, P, 6) and proposal_t (C, T-1, P, 3). The seg parameters'
    names start with "seg.", so engine.make_optimizer puts them in the seg
    group. Built from a list of BaseModels (copied); `row(i)` hands row i
    back as a BaseModel. Its forward is `rows_forward`."""

    def __init__(self, models: Sequence[BaseModel]):
        super().__init__()

        def stack(tensors):
            return torch.stack([t.detach() for t in tensors]).clone()

        layers = [m.seg.layers for m in models]
        depth = len(layers[0])
        self.seg = RowsSeg(
            [stack([ls[i].weight for ls in layers]) for i in range(depth)],
            [stack([ls[i].bias for ls in layers]) for i in range(depth - 1)])
        self.proposal_6d = nn.Parameter(stack([m.proposal_6d for m in models]))
        self.proposal_t = nn.Parameter(stack([m.proposal_t for m in models]))

    @property
    def rows(self) -> int:
        return self.proposal_6d.shape[0]

    @property
    def num_parts(self) -> int:
        return self.proposal_6d.shape[2]

    def row(self, i: int) -> BaseModel:
        """Row i as a BaseModel on this module's device (a copy)."""
        w = self.seg.weight
        model = BaseModel(self.num_parts, self.proposal_6d.shape[1],
                          hidden=w[0].shape[1], device=w[0].device)
        state = {"proposal_6d": self.proposal_6d[i],
                 "proposal_t": self.proposal_t[i]}
        for j, wj in enumerate(w):
            state[f"seg.layers.{j}.weight"] = wj[i]
            if j < len(self.seg.bias):
                state[f"seg.layers.{j}.bias"] = self.seg.bias[j][i]
        model.load_state_dict({k: v.detach().clone()
                               for k, v in state.items()})
        return model


def rows_forward(model: BaseRows, cano_pc: torch.Tensor, noise: torch.Tensor,
                 tau=1.0):
    """base_forward of every row: cano_pc (C, N, 3), noise the (N, P) Gumbel
    draw every row shares or (C, N, P), one a row. Returns (pc_trans_list
    (C, T-1, N, 3), seg_argmax (C, N), trans_list (C, T-1, P, 4, 4)).

    Each row runs base_forward's own calls on views of its parameters, so
    its products (and their gradients' reductions over the points) are the
    library calls of the sequential fit and a row equals its sequential fit
    bit for bit on the card too; the kernels after the forward take the
    rows as one batch. (Batched products round otherwise on the card, and
    from the identity start that parts the fits: ROADMAP.md §3 item 27.)"""
    outs = [base_forward(
        _RowView(model.seg.row(i), model.proposal_6d[i], model.proposal_t[i]),
        cano_pc[i], noise if noise.dim() == 2 else noise[i], tau)
        for i in range(model.rows)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def init_batched_params(batch: int, num_parts: int, pose_len: int,
                        generator: torch.Generator | None = None,
                        device=None) -> BaseRows:
    """Independent base-model parameters for a batch of sequences: `batch`
    BaseModels drawn one after another from `generator` (the JAX package
    splits its key into `batch`), on `device` (the card when None)."""
    dev = resolve_device(device)
    return BaseRows([BaseModel(num_parts, pose_len, generator=generator,
                               device=dev) for _ in range(batch)])


def _fit_base_rows(cfg, cano_b, pc_b, cano_idx_b, num_parts: int,
                   flow_b=None, seed: int = 0, init_model=None, noise=None,
                   device=None):
    """One relaxation fit a row, the rows as one: cano_b (C, N, 3), pc_b
    (C, T-1, N, 3), cano_idx_b C ints; flow_b a FlowContext with (C, T-1,
    M, 3) leaves, or None. Every row starts from `init_model()` (default: a
    BaseModel seeded with `seed`, as the command line's) and shares the
    draw `noise(it)` (default: a generator seeded with `seed` on the
    device), so row i is the sequential fit_base of row i. Returns (the
    BaseRows, seg (C, N), trans (C, T-1, P, 4, 4)) of the final forward at
    tau 1."""
    from reart_tpu_torch.train.engine import fit

    dev = resolve_device(device)
    cano = torch.as_tensor(cano_b, dtype=torch.float32, device=dev)
    pcs = torch.as_tensor(pc_b, dtype=torch.float32, device=dev)
    c, t_minus1, n = pcs.shape[:3]
    if init_model is None:
        def init_model():
            return BaseModel(num_parts, t_minus1, device=dev,
                             generator=torch.Generator().manual_seed(seed))
    model = BaseRows([init_model().to(dev)] * c)
    shape = (n, num_parts)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def noise(_it):
            return gumbel_noise(shape, gen, dev)

    if flow_b is not None:
        flow_b = flow_b.to(dev)
    fit(rows_forward, model, cfg, cano, pcs, noise, flow_ctx=flow_b,
        two_group_opt=True, cano_idx=list(cano_idx_b))
    with torch.no_grad():  # at tau 1 the labels are the logits' argmax
        _, seg, trans = rows_forward(model, cano,
                                     torch.zeros(shape, device=dev), 1.0)
    return model, seg, trans


def fit_base_sequences(cfg, cano_b, pc_b, cano_idx: int, num_parts: int,
                       flow_b=None, seed: int = 0, init_model=None,
                       noise: Callable | None = None, device=None):
    """Fit a batch of different sequences of one shape as one rows fit (the
    `--batch_seq` sapien sweep; the reference runs a process per sequence).
    cano_b (B, N, 3), pc_b (B, T-1, N, 3), every row at cano_idx and cfg;
    flow_b a FlowContext with per-row leaves. Returns a list of (BaseModel,
    seg (N,), trans (T-1, P, 4, 4)) a row, tensors on the device."""
    b = len(cano_b)
    model, seg, trans = _fit_base_rows(
        cfg, cano_b, pc_b, [int(cano_idx)] * b, num_parts, flow_b=flow_b,
        seed=seed, init_model=init_model, noise=noise, device=device)
    return [(model.row(i), seg[i], trans[i]) for i in range(b)]


def fit_base_candidates(cfg, complete_pc_list, num_parts: int, candidates,
                        seed: int = 0, init_model=None,
                        noise: Callable | None = None, device=None):
    """One relaxation fit per candidate canonical frame, the candidates as
    one rows fit (the batched `--auto_cano` sweep). complete_pc_list (T, N,
    3). Each requested candidate is fitted and returned once. Returns
    {cano_idx: (BaseModel, seg (N,), trans (T-1, P, 4, 4))}."""
    complete = to_numpy(complete_pc_list).astype(np.float32)
    cand = list(dict.fromkeys(int(i) for i in candidates))
    cano_b = np.stack([complete[i] for i in cand])
    pc_b = np.stack([np.concatenate([complete[:i], complete[i + 1:]])
                     for i in cand])
    model, seg, trans = _fit_base_rows(
        cfg, cano_b, pc_b, cand, num_parts, seed=seed,
        init_model=init_model, noise=noise, device=device)
    return {idx: (model.row(r), seg[r], trans[r])
            for r, idx in enumerate(cand)}


def make_batched_fit_step(tau: float = 1.0, use_assign: bool = False,
                          downsample: int = 4, lambda_assign: float = 3e-1):
    """One optimisation step over a batch of sequences: per row the summed
    bidirectional Chamfer and, with `use_assign`, a cold auction assignment
    (2 epsilon phases, 64 sweeps) on FPS contexts rebuilt in the step.

    Returns step(model, opt, cano_pc (B, N, 3), pc_list (B, T, N, 3),
    noise (B, N, P)) -> per-row losses (B,), the step taken on `model` by
    `opt` (the summed loss gives each row its own gradient)."""
    from reart_tpu_torch.ops.assignment import auction_lap
    from reart_tpu_torch.ops.distance import (
        nn_bidir_sqdist_with_idx,
        pairwise_sqdist,
    )
    from reart_tpu_torch.train.engine import build_assign_context, select_rows

    def step(model, opt, cano_pc, pc_list, noise):
        with torch.no_grad():
            actx = (build_assign_context(cano_pc, pc_list, downsample)
                    if use_assign else None)
        pc_trans, _, _ = rows_forward(model, cano_pc, noise, tau)
        (d_fwd, _), (d_bwd, _) = nn_bidir_sqdist_with_idx(pc_trans, pc_list)
        losses = d_fwd.sum(dim=(1, 2)) + d_bwd.sum(dim=(1, 2))
        if use_assign:
            pc_src = select_rows(actx, pc_trans)
            cost = torch.sqrt(pairwise_sqdist(pc_src.detach(), actx.pc_tgt))
            perm = auction_lap(cost, num_scales=2, max_sweeps=64)
            matched = torch.gather(actx.pc_tgt, 1,
                                   perm[..., None].expand(-1, -1, 3))
            sq = ((pc_src - matched) ** 2).reshape(cano_pc.shape[0], -1)
            losses = losses + lambda_assign * sq.sum(dim=1)
        opt.zero_grad(set_to_none=True)
        losses.sum().backward()
        opt.step()
        return losses.detach()

    return step


def fit_batch(params: BaseRows, cano_pc, pc_list, n_iter: int,
              lr: float = 1e-2, tau: float = 1.0, use_assign: bool = False,
              downsample: int = 4, noise=None, seed: int = 0, device=None):
    """Fit a batch of sequences in lockstep: `n_iter` steps of
    make_batched_fit_step under one Adam(lr) group. params: a BaseRows
    (init_batched_params), trained in place after a move to `device` (the
    card when None). cano_pc (B, N, 3), pc_list (B, T, N, 3). noise (B, N,
    P): each row's Gumbel draw, the same in every step (the JAX package
    splits its key once); by default drawn once from a generator seeded
    with `seed`. Returns (params, per-row losses (B,) of the last step)."""
    dev = resolve_device(device)
    params = params.to(dev)
    cano = torch.as_tensor(cano_pc, dtype=torch.float32, device=dev)
    pcs = torch.as_tensor(pc_list, dtype=torch.float32, device=dev)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = gumbel_noise(cano.shape[:2] + (params.num_parts,), gen, dev)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    step = make_batched_fit_step(tau=tau, use_assign=use_assign,
                                 downsample=downsample)
    losses = None
    for _ in range(n_iter):
        losses = step(params, opt, cano, pcs, noise)
    return params, losses
