"""Inverse kinematics: retargeting a fitted model to novel states
(reart_tpu/ik.py).

For each novel pose, 200 AMSGrad steps at lr 0.1 move a single-frame pose
override (the kinematic model's (1, E) joint angles, or the base model's
free (1, P) proposals) so that the forward carries a few sparse canonical
points onto their novel positions; the retarget error is the mean distance
of the whole cloud carried by the solved pose to its GT novel position.

The update is written out here as `optax.amsgrad` does it, not taken from
`torch.optim.Adam(amsgrad=True)`: optax keeps the running maximum of the
bias-corrected second moment, PyTorch the maximum of the raw one and
corrects afterwards, and the two part ways in the early steps, where 200
steps at lr 0.1 start.
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import device_of
from reart_tpu_torch.data.common import (  # noqa: F401  (re-exported)
    sparse_sample_novel_state,
)
from reart_tpu_torch.models.base_model import (
    IDENTITY_6D,
    base_forward,
    gumbel_noise,
)
from reart_tpu_torch.models.kinematic import PIN, kinematic_forward


def amsgrad_init(params: list) -> dict:
    """State of `amsgrad_update` for a list of tensors."""
    zeros = lambda: [torch.zeros_like(p) for p in params]
    return {"count": 0, "mu": zeros(), "nu": zeros(), "nu_max": zeros()}


@torch.no_grad()
def amsgrad_update(params: list, grads: list, state: dict, lr: float,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> None:
    """One AMSGrad step in place on `params` and `state`: first and second
    moments, both bias-corrected, the running maximum taken of the
    corrected second moment, step -lr * (mu_hat / (sqrt(nu_max) + eps)).
    The bias corrections are rounded to float32 and every product is taken
    in optax's order, so the two agree to the last bits."""
    state["count"] += 1
    c1 = float(np.float32(1.0) - np.float32(b1) ** state["count"])
    c2 = float(np.float32(1.0) - np.float32(b2) ** state["count"])
    for p, g, mu, nu, nu_max in zip(params, grads, state["mu"], state["nu"],
                                    state["nu_max"]):
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        torch.maximum(nu_max, nu / c2, out=nu_max)
        p.add_(-lr * ((mu / c1) / (torch.sqrt(nu_max) + eps)))


def _solve(loss_fn, opt_params: list, n_iter: int, lr: float):
    """`n_iter` AMSGrad steps on the tensors of `opt_params` (in place).
    Returns the (n_iter,) losses, each taken before its step."""
    for p in opt_params:
        p.requires_grad_(True)
    state = amsgrad_init(opt_params)
    losses = []
    for _ in range(n_iter):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, opt_params)
        amsgrad_update(opt_params, grads, state, lr)
        losses.append(loss.detach())
    for p in opt_params:
        p.requires_grad_(False)
    return torch.stack(losses)


def ik_solve_kinematic(params, state, sparse_cano_pc, sparse_novel_pc,
                       n_iter: int = 200, lr: float = 1e-1):
    """Optimise a (1, E) joint-angle override so that FK carries the sparse
    canonical points onto the sparse novel points. Tensors on the model's
    device. Returns (theta (1, E), losses (n_iter,))."""
    theta = torch.full((1, params.theta_list.shape[1]), PIN,
                       dtype=torch.float32, device=params.theta_list.device)

    def loss_fn():
        pc_trans, _, _ = kinematic_forward(params, state, sparse_cano_pc,
                                           theta_list=theta)
        return torch.sum((pc_trans[0] - sparse_novel_pc) ** 2)

    losses = _solve(loss_fn, [theta], n_iter, lr)
    return theta, losses


def ik_solve_base(params, sparse_cano_pc, sparse_novel_pc, noise,
                  tau: float = 1.0, n_iter: int = 200, lr: float = 1e-1):
    """Base-model branch: optimise free single-frame proposals. `noise` is
    the (n_sparse, P) Gumbel draw of every forward. Returns
    ({"proposal_6d" (1, P, 6), "proposal_t" (1, P, 3)}, losses)."""
    p = params.num_parts
    dev = params.proposal_6d.device
    ident = torch.tensor(IDENTITY_6D, device=dev)
    opt = {"proposal_6d": ident.repeat(1, p, 1),
           "proposal_t": torch.zeros((1, p, 3), device=dev)}

    def loss_fn():
        pc_trans, _, _ = base_forward(params, sparse_cano_pc, noise, tau,
                                      **opt)
        return torch.sum((pc_trans[0] - sparse_novel_pc) ** 2)

    losses = _solve(loss_fn, list(opt.values()), n_iter, lr)
    return opt, losses


def ik(sample: dict, model_kind: str, params, state=None,
       generator: torch.Generator | None = None, tau: float = 1.0,
       n_iter: int = 200, verbose: bool = False, device=None) -> float:
    """Retargeting over a sequence's novel poses. `sample` is the dataset's
    dict with what the JAX package reads off the dataset object beside it:
    `pose_list` (per frame {part: 4x4}), `cano_idx` and `novel_pose_list`.
    Runs on the model's device. `generator` draws the base model's Gumbel
    noise. Returns the mean retarget error x100 (cm), 9999.0 without novel
    poses. The html views of the JAX package are not written."""
    dev = device_of(*params.parameters(), device=device)
    cano_pose = sample["pose_list"][sample["cano_idx"]]
    cano_np = np.asarray(sample["cano_pc"])
    cano_pc = torch.as_tensor(cano_np, dtype=torch.float32, device=dev)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    errs = []
    for novel_pose in sample["novel_pose_list"]:
        novel = sparse_sample_novel_state(
            cano_np, np.asarray(sample["gt_cano_part"]), cano_pose,
            novel_pose)
        s_cano = tensor(novel["sparse_cano_pc"])
        s_novel = tensor(novel["sparse_novel_pc"])
        if model_kind == "kinematic":
            theta, _ = ik_solve_kinematic(params, state, s_cano, s_novel,
                                          n_iter=n_iter)
            with torch.no_grad():
                pc_trans, _, _ = kinematic_forward(params, state, cano_pc,
                                                   theta_list=theta)
        else:
            p = params.num_parts
            opt, _ = ik_solve_base(
                params, s_cano, s_novel,
                gumbel_noise((s_cano.shape[0], p), generator, dev), tau=tau,
                n_iter=n_iter)
            with torch.no_grad():
                pc_trans, _, _ = base_forward(
                    params, cano_pc,
                    gumbel_noise((cano_pc.shape[0], p), generator, dev), tau,
                    **opt)
        pred = pc_trans[0].cpu().numpy()
        err = 100.0 * float(
            np.sqrt(((pred - novel["novel_pc"]) ** 2).sum(axis=-1)).mean())
        if verbose:
            print(f"Novel retarget err: {err:.3f}")
        errs.append(err)
    return float(np.mean(errs)) if errs else 9999.0
