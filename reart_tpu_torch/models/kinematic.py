"""Projection ("kinematic") model: forward kinematics over a compiled tree
(reart_tpu/models/kinematic.py).

The kinematic tree is compiled once on the host into a padded (P, D) matrix
of edge indices along each part's path to the root, child side first, padded
with an identity sentinel at index E. Per part p,
    pose_p = T(e_{k-1}) @ ... @ T(e_1) @ T(e_0)
for the edges e_0..e_{k-1} on its path: one gather of the (E + 1) edge
transforms through the path matrix and a left fold over the depth D, a short
Python loop of batched 4x4 products for all parts at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from reart_tpu_torch import resolve_device
from reart_tpu_torch.geometry import (
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
    rt_to_transform,
)
from reart_tpu_torch.geometry.screw import screw_transform
from reart_tpu_torch.models.base_model import (
    IDENTITY_6D,
    transform_points_blend,
)
from reart_tpu_torch.ops.distance import knn_transfer_labels

PIN = 1e-6  # inactive screw coordinate (numerical-stability pinning)


@dataclasses.dataclass(frozen=True)
class KinematicState:
    """What the projection model holds besides its parameters: tensors on
    one device plus the static topology. `edges`, `edge_index` and
    `reverse_topo` are kept for the result files and checkpoints;
    `path_edges` is the compiled form."""

    seg_part: torch.Tensor         # (N,) int64
    cano_pc: torch.Tensor          # (N, 3)
    num_parts: int
    path_edges: torch.Tensor       # (P, D) int64; edge idx child-first, pad E
    prismatic_mask: torch.Tensor | None  # (E,) bool, None = revolute only
    edges: tuple                   # ((child, parent), ...) in edge-index order
    reverse_topo: tuple            # root-to-leaf part order
    has_root_trans: bool = False

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    @property
    def edge_index(self) -> dict:
        """{"child_parent": idx}, the reference's edge_index."""
        return {f"{c}_{p}": i for i, (c, p) in enumerate(self.edges)}

    def to(self, device) -> "KinematicState":
        pris = self.prismatic_mask
        return dataclasses.replace(
            self, seg_part=self.seg_part.to(device),
            cano_pc=self.cano_pc.to(device),
            path_edges=self.path_edges.to(device),
            prismatic_mask=None if pris is None else pris.to(device))


def compile_tree(edges, root: int, num_parts: int, pad_depth=None):
    """Host side: child->parent edge list -> (path_edges, reverse_topo).

    edges: (child, parent) pairs covering parts 0..P-1 (a tree: E = P - 1).
    Returns a (P, D) int32 numpy array of edge indices along each part's
    path to the root (child first, padded with E) and the root-to-leaf part
    order. `pad_depth` forces D (identity-padded), so trees of different
    depth share one shape."""
    edges = [(int(c), int(p)) for c, p in edges]
    e = len(edges)
    assert e == num_parts - 1, "invalid tree: E must equal P-1"
    parent = {}
    edge_of = {}
    for idx, (c, p) in enumerate(edges):
        assert c not in parent, f"part {c} has two parents"
        parent[c] = p
        edge_of[c] = idx
    assert root not in parent, "root must have no parent"

    paths = []
    for part in range(num_parts):
        path = []
        cur = part
        seen = set()
        while cur != root:
            assert cur in parent, f"part {cur} disconnected from root {root}"
            assert cur not in seen, "cycle in kinematic tree"
            seen.add(cur)
            path.append(edge_of[cur])
            cur = parent[cur]
        paths.append(path)
    depth = max((len(p) for p in paths), default=1)
    depth = max(depth, 1)
    if pad_depth is not None:
        assert pad_depth >= depth, "pad_depth shallower than the tree"
        depth = pad_depth
    path_edges = np.full((num_parts, depth), e, dtype=np.int32)
    for part, path in enumerate(paths):
        path_edges[part, : len(path)] = path

    # root-to-leaf order (BFS), checkpoint metadata
    children = {}
    for c, p in edges:
        children.setdefault(p, []).append(c)
    order, queue = [], [root]
    while queue:
        cur = queue.pop(0)
        order.append(cur)
        queue.extend(sorted(children.get(cur, [])))
    return path_edges, tuple(order)


def make_kinematic_state(seg_part, cano_pc, edges, root: int,
                         joint_types=None, has_root_trans: bool = False,
                         pad_depth=None, device=None) -> KinematicState:
    """The static state from the graph stage's outputs, on `device` (the
    card when None). joint_types: "revolute"/"prismatic" per edge, or a
    bool array (True = prismatic); None builds a revolute-only model."""
    device = resolve_device(device)
    seg_np = np.asarray(torch.as_tensor(seg_part).cpu())
    num_parts = int(seg_np.max()) + 1
    path_edges, reverse_topo = compile_tree(edges, root, num_parts,
                                            pad_depth=pad_depth)
    if joint_types is None:
        pris = None
    elif (isinstance(joint_types, (list, tuple)) and joint_types
          and isinstance(joint_types[0], str)):
        pris = torch.tensor([t == "prismatic" for t in joint_types],
                            dtype=torch.bool, device=device)
    else:
        pris = torch.as_tensor(np.asarray(joint_types, dtype=bool),
                               device=device)
    return KinematicState(
        seg_part=torch.as_tensor(seg_np, dtype=torch.int64, device=device),
        cano_pc=torch.as_tensor(cano_pc, dtype=torch.float32, device=device),
        num_parts=num_parts,
        path_edges=torch.as_tensor(path_edges, dtype=torch.int64,
                                   device=device),
        prismatic_mask=pris,
        edges=tuple((int(c), int(p)) for c, p in edges),
        reverse_topo=reverse_topo,
        has_root_trans=has_root_trans,
    )


class KinematicModel(nn.Module):
    """Trainable state of the projection stage (the JAX package's
    `init_kinematic_params`), built on the card unless `device` names
    another device. The parameter names are the checkpoint's keys:
    axis_list (E, 3), moment_list (E, 3), theta_list (T, E), optionally
    distance_list (T, E), and root_6d (T, 6) / root_t (T, 3)."""

    def __init__(self, pose_len: int, num_edges: int, axis_list=None,
                 moment_list=None, theta_list=None, distance_list=None,
                 root_trans=None, load_distance: bool = False,
                 load_root_trans: bool = False, *,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)

        def param(value, shape):
            if value is None:
                return nn.Parameter(torch.zeros(shape, device=device))
            return nn.Parameter(torch.as_tensor(
                value, dtype=torch.float32).detach().clone().to(device))

        self.axis_list = param(axis_list, (num_edges, 3))
        self.moment_list = param(moment_list, (num_edges, 3))
        self.theta_list = param(theta_list, (pose_len, num_edges))
        if distance_list is not None or load_distance:
            self.distance_list = param(distance_list, (pose_len, num_edges))
        if root_trans is not None:
            root_trans = torch.as_tensor(root_trans, dtype=torch.float32)
            self.root_6d = param(
                matrix_to_rotation_6d(root_trans[:, :3, :3]), None)
            self.root_t = param(root_trans[:, :3, 3], None)
        elif load_root_trans:
            self.root_6d = param(
                torch.tensor(IDENTITY_6D).repeat(pose_len, 1), None)
            self.root_t = param(None, (pose_len, 3))

    def forward(self, state: KinematicState, input_pc: torch.Tensor,
                theta_list=None, seg_part=None):
        return kinematic_forward(self, state, input_pc, theta_list, seg_part)


def fk(params: KinematicModel, state: KinematicState,
       theta_list: torch.Tensor | None = None) -> torch.Tensor:
    """Forward kinematics -> (T, P, 4, 4) part poses. `theta_list` (T', E)
    overrides the model's angles (inverse kinematics)."""
    theta = params.theta_list if theta_list is None else theta_list  # (T, E)
    t_frames, e = theta.shape
    distance = getattr(params, "distance_list", None)
    pin = torch.full_like(theta, PIN)
    if state.prismatic_mask is not None:
        pris = state.prismatic_mask[None, :]
        assert distance is not None
        theta_eff = torch.where(pris, pin, theta)
        dist_eff = torch.where(pris, distance, pin)
    else:
        theta_eff = theta
        dist_eff = pin if distance is None else distance

    axis = params.axis_list[None].expand(t_frames, e, 3)
    moment = params.moment_list[None].expand(t_frames, e, 3)
    edge_t = screw_transform(axis, moment, theta_eff, dist_eff)  # (T, E, 4, 4)
    eye = torch.eye(4, dtype=edge_t.dtype, device=edge_t.device)
    edge_t = torch.cat([edge_t, eye.expand(t_frames, 1, 4, 4)], dim=1)

    gathered = edge_t[:, state.path_edges]  # (T, P, D, 4, 4)
    # left fold, child first: pose <- M_d @ pose for d = 0..D-1
    pose = eye.expand(t_frames, state.num_parts, 4, 4)
    for d in range(state.path_edges.shape[1]):
        pose = gathered[:, :, d] @ pose
    return pose


def kinematic_forward(params: KinematicModel, state: KinematicState,
                      input_pc: torch.Tensor, theta_list=None, seg_part=None):
    """1-NN seg transfer, FK, optional root premultiply, blend. Returns
    (pc_trans_list (T, N, 3), seg_part (N,), trans_list (T, P, 4, 4)). Pass
    `seg_part` to skip the 1-NN transfer (the fit always forwards the
    canonical cloud itself, where the transfer is the identity)."""
    if seg_part is None:
        seg_part = knn_transfer_labels(input_pc, state.cano_pc,
                                       state.seg_part)
    trans_list = fk(params, state, theta_list=theta_list)
    if hasattr(params, "root_6d"):
        root = rt_to_transform(rotation_6d_to_matrix(params.root_6d),
                               params.root_t)  # (T, 4, 4)
        trans_list = root[:, None] @ trans_list
    weight = F.one_hot(seg_part.long(), state.num_parts).to(input_pc.dtype)
    pc_trans_list = transform_points_blend(weight, trans_list, input_pc)
    return pc_trans_list, seg_part, trans_list
