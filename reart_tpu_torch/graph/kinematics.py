"""Kinematic-tree construction (reart_tpu/graph/kinematics.py): the
relabelling that closes the relaxation run, and between the two stages the
child-to-parent DAG, the per-edge screws and the joint types.

The order of the DAG's edges is the layout of the projection model's
parameters (column e of theta_list belongs to edge e), so `to_dag` keeps the
order the JAX package gets from networkx, in plain dicts: nodes in order of
first appearance, a node's edges in order of insertion.
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import device_of
from reart_tpu_torch.geometry import (
    dq_to_screw,
    inverse_transformation,
    transform_to_dq,
)
from reart_tpu_torch.graph.costs import compute_root_cost


def extract_kinematic(seg_part, trans_list, joint_connection):
    """Relabel the surviving parts to 0..P-1 in all three artifacts:
    seg_part (N,) int, trans_list (T, P_raw, 4, 4) tensor or array,
    joint_connection (E, 2) labels -> (seg (N,) numpy, trans (T, P, 4, 4)
    of trans_list's own kind, edges (E, 2) numpy)."""
    seg_part = np.asarray(seg_part)
    joint_connection = np.asarray(joint_connection)
    uni = np.unique(seg_part)
    assert np.array_equal(np.unique(joint_connection), uni), \
        "edges must cover exactly the labels"
    if isinstance(trans_list, torch.Tensor):
        trans_list = trans_list[:, torch.as_tensor(uni,
                                                   device=trans_list.device)]
    else:
        trans_list = np.asarray(trans_list)[:, uni]
    # uni is sorted, so a label's new id is its rank
    return (np.searchsorted(uni, seg_part), trans_list,
            np.searchsorted(uni, joint_connection))


def to_dag(edges_list, root_node: int) -> list:
    """Undirected tree -> its (child, parent) edges towards `root_node`, in
    the order `list(nx.DiGraph.edges())` has them in the JAX package: every
    node's path to the root is walked in the order the nodes first appear in
    `edges_list`, a path's new edges are appended child side first, and the
    DAG built from that list yields each node's out-edge in the order the
    nodes first appear in it."""
    adj = {}  # node -> neighbours; dicts keep insertion order
    for u, v in edges_list:
        u, v = int(u), int(v)
        adj.setdefault(u, {})[v] = None
        adj.setdefault(v, {})[u] = None
    assert root_node in adj, f"root {root_node} is not a node of the tree"
    parent = {root_node: None}
    queue = [root_node]
    for cur in queue:  # breadth first: the shortest path to the root
        for nb in adj[cur]:
            if nb not in parent:
                parent[nb] = cur
                queue.append(nb)
    assert len(parent) == len(adj), "graph is not connected"
    new_edges = {}
    for node in adj:
        cur = node
        while parent[cur] is not None:
            new_edges.setdefault((cur, parent[cur]), None)
            cur = parent[cur]
    assert len(new_edges) == len(adj) - 1, "invalid tree structure"
    dag_nodes = {}
    for c, p in new_edges:
        dag_nodes.setdefault(c, None)
        dag_nodes.setdefault(p, None)
    return [(n, parent[n]) for n in dag_nodes if parent[n] is not None]


def edge_index2edges(edge_index: dict):
    """{"child_parent": idx} -> [[child, parent], ...]."""
    out = []
    for name in edge_index.keys():
        c, p = name.split("_")
        out.append([int(c), int(p)])
    return out


def build_graph(edges_list, trans_list, verbose: bool = False, root_part=None,
                revolute_only: bool = True, return_joint_type: bool = False,
                rot_amp_thr: float = 0.15, device=None):
    """Per-edge screws and joint types from part trajectories.

    edges_list: (E, 2) tree edges over parts 0..P-1; trans_list
    (T, P, 4, 4), a tensor (its device is used) or an array (moved to
    `device`, the card when None). The root is the part of least motion
    unless `root_part` names it. Returns
      revolute_only: (edges, root, axis (E, 3), moment (E, 3), theta (T, E),
                      edge_index)
      else:          (edges, root, axis, moment, theta, distance (T, E),
                      edge_index[, joint_type_list])
    with `edges` the (child, parent) list of `to_dag` (the JAX package
    returns the networkx DAG in its place) and tensors on the device.

    Mean axis and moment are plain means over time. Typing: an edge is
    prismatic iff the largest rotation angle of its relative motion is below
    `rot_amp_thr` radians; a prismatic edge's axis is the principal
    direction of its relative translations (sign so that its components sum
    to >= 0), its distance the projection onto that axis. The revolute-only
    build asserts that no frame is without rotation."""
    edges_list = np.asarray(edges_list)
    dev = device_of(trans_list, device=device)
    trans_list = torch.as_tensor(trans_list, dtype=torch.float32, device=dev)
    t, p = trans_list.shape[:2]
    uni = np.unique(edges_list)
    assert np.array_equal(uni, np.arange(p)), "edges must cover parts 0..P-1"

    if root_part is None:
        root_cost = compute_root_cost(trans_list).cpu().numpy()
        root_part = int(uni[root_cost.argmin()])
    if verbose:
        print("root part id", root_part)

    edges = to_dag(edges_list.tolist(), root_node=root_part)
    e = len(edges)
    child = torch.tensor([c for c, _ in edges], dtype=torch.long, device=dev)
    parent = torch.tensor([pp for _, pp in edges], dtype=torch.long,
                          device=dev)

    # per-edge relative trajectories and their screws, all edges at once
    rel_trans = (inverse_transformation(trans_list[:, parent])
                 @ trans_list[:, child])  # (T, E, 4, 4)
    s_axis, moment, theta, distance = dq_to_screw(
        transform_to_dq(rel_trans.reshape(-1, 4, 4)))
    s_axis = s_axis.reshape(t, e, 3)
    moment = moment.reshape(t, e, 3)
    theta = theta.reshape(t, e)
    distance = distance.reshape(t, e)
    mean_axis = s_axis.mean(dim=0)   # (E, 3)
    mean_moment = moment.mean(dim=0)

    edge_index = {f"{c}_{pp}": i for i, (c, pp) in enumerate(edges)}

    if revolute_only:
        th = theta.cpu().numpy()
        no_rot = (np.abs(th) < 1e-6) | (np.abs(th - np.pi) < 1e-6)
        assert no_rot.sum() == 0, "revolute-only build hit a no-rotation frame"
        if verbose:
            print(f"joint types at each edge: {['revolute'] * e}")
        return edges, root_part, mean_axis, mean_moment, theta, edge_index

    rel_np = rel_trans.cpu().numpy()
    tvecs = rel_np[..., :3, 3].astype(np.float64)  # (T, E, 3)
    cov = np.einsum("tei,tej->eij", tvecs, tvecs)  # (E, 3, 3)
    _, vecs = np.linalg.eigh(cov)
    axis_p = vecs[:, :, -1]  # (E, 3) dominant direction
    sign = np.where(axis_p.sum(axis=-1) < 0, -1.0, 1.0)
    axis_p = torch.as_tensor(axis_p * sign[:, None], dtype=torch.float32,
                             device=dev)
    distance_p = torch.einsum("tei,ei->te", rel_trans[..., :3, 3], axis_p)

    tr_rot = np.trace(rel_np[..., :3, :3].astype(np.float64), axis1=-2,
                      axis2=-1)
    ang = np.arccos(np.clip((tr_rot - 1.0) / 2.0, -1.0, 1.0))  # (T, E)
    pris_np = ang.max(axis=0) < rot_amp_thr  # (E,)
    joint_type_list = ["prismatic" if x else "revolute" for x in pris_np]
    pris = torch.as_tensor(pris_np, device=dev)
    # prismatic edges carry the translation's axis; revolute edges the mean
    # screw axis
    mean_axis = torch.where(pris[:, None], axis_p, mean_axis)
    theta_out = torch.where(pris[None, :], torch.full_like(theta, 1e-6),
                            theta)
    distance_out = torch.where(pris[None, :], distance_p,
                               torch.full_like(distance_p, 1e-6))
    if verbose:
        print(f"joint types at each edge: {joint_type_list}")
    out = (edges, root_part, mean_axis, mean_moment, theta_out, distance_out,
           edge_index)
    return out + (joint_type_list,) if return_joint_type else out
