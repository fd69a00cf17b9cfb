"""Greedy MST, part merging and segmentation cleanup
(reart_tpu/graph/mst.py).

The combinatorial logic is numpy and plain Python on the host; the costs
are tensor code on the device of `cano_pc` (graph/costs.py). The greedy MST
keeps the reference's tie-breaking (row-major argmin of the masked float64
cost matrix) and its connectivity bookkeeping, because the order of the
edges it returns feeds the merge pass.

`merge_graph` keeps its part graph in insertion-ordered dicts instead of a
networkx DiGraph: the topological order (generations, nodes and successors
in insertion order) and the edge contraction (the contracted node's
in-edges, then its out-edges, appended to the surviving node) are those of
`networkx.topological_sort` and `networkx.contracted_edge`, so labels and
remaining edges come out in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from reart_tpu_torch import device_of, to_numpy
from reart_tpu_torch.geometry import inverse_transformation
from reart_tpu_torch.graph.costs import (
    compute_geo_cost,
    compute_joint_cost,
    compute_relative_trans,
    compute_spatial_cost,
    fps_index_list,
    fps_sample_cano,
)
from reart_tpu_torch.models.base_model import compute_pc_transform
from reart_tpu_torch.ops import knn_transfer_labels


def filter_seg_label(cano_part, min_num: int = 10) -> np.ndarray:
    """Labels with at least `min_num` members."""
    uni, cnt = np.unique(to_numpy(cano_part), return_counts=True)
    return uni[cnt >= min_num]


def denoise_seg_label(cano_part, cano_pc, min_num: int = 10,
                      device=None) -> np.ndarray:
    """Reassign the points of tiny parts to the label of their nearest
    point among the big parts. cano_part (N,) int; cano_pc (N, 3) tensor, or
    array moved to `device` (the card when None), where the 1-NN runs.
    Returns (N,) numpy labels."""
    dev = device_of(cano_pc, device=device)
    cano_part = to_numpy(cano_part).copy()
    uni, cnt = np.unique(cano_part, return_counts=True)
    small = uni[cnt < min_num]
    if small.size == 0:
        return cano_part
    mask = np.isin(cano_part, small)
    if mask.all():
        return cano_part
    pc = torch.as_tensor(cano_pc, dtype=torch.float32, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    new_labels = knn_transfer_labels(
        pc[mask_t], pc[~mask_t], torch.as_tensor(cano_part[~mask], device=dev))
    cano_part[mask] = new_labels.cpu().numpy()
    return cano_part


def mst(cost, uni_label=None, max_cost=None, keep_index: bool = False,
        verbose: bool = False) -> np.ndarray:
    """Greedy minimum spanning tree over a (P, P) cost matrix: (P-1, 2)
    edges in selection order (labels from `uni_label` unless `keep_index`).
    Pure numpy, float64."""
    cost = np.asarray(cost, dtype=np.float64)
    num_parts = cost.shape[0]
    if uni_label is not None:
        uni_label = np.asarray(uni_label)
        assert num_parts == len(uni_label)
    connectivity = np.eye(num_parts, dtype=np.int64)
    edges = np.zeros((num_parts - 1, 2), dtype=np.int64)
    for j in range(num_parts - 1):
        cur = cost + connectivity * 1e10
        flat = int(np.argmin(cur))
        i0, i1 = flat // num_parts, flat % num_parts
        if max_cost is not None and cur[i0, i1] > max_cost:
            return edges[:j]
        if verbose:
            a = uni_label[i0] if uni_label is not None else i0
            b = uni_label[i1] if uni_label is not None else i1
            print(a, b, cur[i0, i1])
        connectivity[i0] = np.maximum(connectivity[i0], connectivity[i1])
        connectivity[connectivity[i0] == 1] = connectivity[i0]
        if uni_label is None or keep_index:
            edges[j] = (i0, i1)
        else:
            edges[j] = (uni_label[i0], uni_label[i1])
    return edges


class _PartGraph:
    """A directed graph with edge costs in insertion-ordered dicts:
    succ[u][v] = cost, pred[v] = {u: None}."""

    def __init__(self, nodes):
        self.succ = {n: {} for n in nodes}
        self.pred = {n: {} for n in self.succ}

    def add_edge(self, u, v, cost):
        for n in (u, v):
            self.succ.setdefault(n, {})
            self.pred.setdefault(n, {})
        self.succ[u][v] = cost
        self.pred[v][u] = None

    def edges(self):
        return [(u, v) for u, nbrs in self.succ.items() for v in nbrs]

    def topological_order(self):
        """Kahn's algorithm by generations; None if the graph has a cycle."""
        indeg = {n: len(p) for n, p in self.pred.items()}
        generation = [n for n, d in indeg.items() if d == 0]
        order = []
        while generation:
            order.extend(generation)
            following = []
            for node in generation:
                for child in self.succ[node]:
                    indeg[child] -= 1
                    if indeg[child] == 0:
                        following.append(child)
            generation = following
        return order if len(order) == len(self.succ) else None

    def contract(self, u, v):
        """Merge v into u: v's in-edges, then its out-edges, are re-attached
        to u (an edge that u already has keeps its own cost); the edges
        between u and v are dropped."""
        incoming = [(w, self.succ[w][v]) for w in self.pred[v]]
        outgoing = list(self.succ[v].items())
        for w in self.pred.pop(v):
            del self.succ[w][v]
        for x in self.succ.pop(v):
            del self.pred[x][v]
        for w, c in incoming:
            if w != u and u not in self.succ[w]:
                self.add_edge(w, u, c)
        for x, c in outgoing:
            if x != u and x not in self.succ[u]:
                self.add_edge(u, x, c)

    def is_weakly_connected(self):
        if not self.succ:
            return False
        start = next(iter(self.succ))
        seen, stack = {start}, [start]
        while stack:
            n = stack.pop()
            for nb in (*self.succ[n], *self.pred[n]):
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        return len(seen) == len(self.succ)


def merge_graph(seg_part, joint_connection, trans_list, merge_thr: float,
                verbose: bool = False, device=None):
    """Contract near-rigid edges (relative motion ~ identity over time).
    seg_part (N,) int, joint_connection (E, 2) labels, trans_list
    (T, P, 4, 4) tensor, or array moved to `device` (the card when None)
    -> (merged labels (N,), remaining edges (E', 2)), both numpy."""
    seg_part = to_numpy(seg_part).copy()
    joint_connection = np.asarray(joint_connection)
    trans = torch.as_tensor(trans_list, dtype=torch.float32,
                            device=device_of(trans_list, device=device))
    conn = torch.as_tensor(joint_connection, device=trans.device)

    rel = inverse_transformation(trans[:, conn[:, 0]]) @ trans[:, conn[:, 1]]
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device)
    # (E,) Frobenius cost against the identity, time-mean
    vanilla = torch.mean(torch.sum((rel - eye) ** 2, dim=(-2, -1)),
                         dim=0).cpu().numpy()

    m = _PartGraph(int(pid) for pid in np.unique(joint_connection))
    for idx, edge in enumerate(joint_connection):
        m.add_edge(int(edge[0]), int(edge[1]), float(vanilla[idx]))
        if verbose:
            print(f"add edge {edge[0]}-{edge[1]}: cost {vanilla[idx]}")

    topo = m.topological_order()
    if topo is None:
        raise ValueError("the candidate edges form a directed cycle")
    for node in topo:
        if node not in m.succ:
            continue
        for child, c in list(m.succ[node].items()):
            if child in m.succ and c < merge_thr:
                m.contract(node, child)
                seg_part[seg_part == child] = node
                if verbose:
                    print(f"merge edge {child}-{node}: cost {c}")

    if not m.is_weakly_connected():
        raise ValueError("merge left the part graph disconnected")
    if m.topological_order() is None:
        raise ValueError("merge produced a cyclic part graph")
    return seg_part, np.array([[a, b] for a, b in m.edges()], dtype=np.int64)


def _anchor_costs(seg_part: np.ndarray, pred_pc_list: torch.Tensor,
                  cano_pc: torch.Tensor, num_fps: int):
    """Per-part FPS anchors, their minimum canonical distances and the
    temporal joint-contact cost of every ordered part pair, the anchors
    tracked through pred_pc_list (T, N, 3):
    (uni_label (P,) numpy, cano_dist (P, P), joint_cost (P, P))."""
    dev = cano_pc.device
    seg_t = torch.as_tensor(seg_part, device=dev)
    uni_label = np.unique(seg_part)
    fps, fps_idx = fps_sample_cano(cano_pc, seg_t,
                                   torch.as_tensor(uni_label, device=dev),
                                   num_fps=num_fps)
    part_fps_list = fps_index_list(pred_pc_list, fps_idx)
    cano_dist, pair_idx = compute_spatial_cost(fps, return_index=True)
    p = len(uni_label)
    grid = torch.stack(torch.meshgrid(torch.arange(p, device=dev),
                                      torch.arange(p, device=dev),
                                      indexing="ij"), -1)
    dist = compute_joint_cost(part_fps_list, grid.reshape(-1, 2),
                              pair_idx.reshape(-1, 2))
    return uni_label, cano_dist, torch.sum(dist.reshape(-1, p, p), dim=0)


def _inputs(trans_list, cano_pc, device):
    dev = device_of(cano_pc, trans_list, device=device)
    return (torch.as_tensor(trans_list, dtype=torch.float32, device=dev),
            torch.as_tensor(cano_pc, dtype=torch.float32, device=dev))


@torch.no_grad()
def merging_wrapper(seg_part, trans_list, cano_pc, merge_thr: float,
                    n_it: int = 2, device=None) -> np.ndarray:
    """Iterated MST + near-rigid contraction. seg_part (N,) int,
    trans_list (T, P, 4, 4), cano_pc (N, 3): tensors, or arrays moved to
    `device` (the card when None). Returns (N,) numpy labels."""
    seg_part = to_numpy(seg_part)
    trans, cano = _inputs(trans_list, cano_pc, device)
    # the predicted clouds come from the labels before any merge, in every
    # iteration (the reference computes them once)
    pred_pc_list = compute_pc_transform(
        cano, trans, torch.as_tensor(seg_part, device=cano.device))
    for _ in range(n_it):
        uni_label, cano_dist, joint_cost = _anchor_costs(
            seg_part, pred_pc_list, cano, 20)
        p = len(uni_label)
        merge_cost = (cano_dist + joint_cost
                      + 1e4 * torch.eye(p, device=cano.device))
        candidates = mst(merge_cost.cpu().numpy(), uni_label=uni_label)
        seg_part, _ = merge_graph(seg_part, candidates, trans, merge_thr)
        if not len(np.unique(seg_part)) > 1:
            break
    return seg_part


@torch.no_grad()
def mst_wrapper(seg_part, trans, cano_pc, verbose: bool = False,
                num_fps: int = 20, cano_dist_thr: float = 1e-2,
                joint_cost_weight: float = 100.0, return_cost: bool = False,
                device=None):
    """Kinematic-tree candidate selection: spatial gate + screw-geodesic +
    weighted temporal joint cost -> greedy MST. Inputs as merging_wrapper's.
    Returns the (P-1, 2) numpy edges; with `return_cost` also the (P, P)
    cost matrix and the label vector it is indexed by."""
    seg_part = to_numpy(seg_part)
    trans, cano = _inputs(trans, cano_pc, device)
    pred_pc_list = compute_pc_transform(
        cano, trans, torch.as_tensor(seg_part, device=cano.device))
    uni_label, cano_dist, joint_cost = _anchor_costs(seg_part, pred_pc_list,
                                                     cano, num_fps)
    uni = torch.as_tensor(uni_label, device=cano.device)

    axis, moment, theta, distance, rel_trans = compute_relative_trans(
        trans, return_trans=True)

    def sel(x):
        return x[:, uni][:, :, uni]

    geo_cost = compute_geo_cost(sel(rel_trans), sel(axis), sel(moment),
                                sel(theta), sel(distance))
    dist_cost = torch.where(cano_dist < cano_dist_thr, 0.0, 1e4)
    cost = dist_cost + geo_cost + joint_cost_weight * joint_cost
    cost = (cost + 1e4 * torch.eye(len(uni_label), device=cano.device)
            ).cpu().numpy()
    edges = mst(cost, uni_label=uni_label, verbose=verbose)
    if return_cost:
        return edges, cost, uni_label
    return edges


def _tree_path(edges, p: int, u: int, v: int) -> list:
    """The nodes of the unique u-v path of a tree over parts 0..p-1, from u
    to v (what networkx.shortest_path returns on a tree)."""
    nbrs = {n: [] for n in range(p)}
    for a, b in edges:
        nbrs[int(a)].append(int(b))
        nbrs[int(b)].append(int(a))
    parent, stack = {u: None}, [u]
    while stack:
        n = stack.pop()
        for m in nbrs[n]:
            if m not in parent:
                parent[m] = n
                stack.append(m)
    path = [v]
    while path[-1] != u:
        path.append(parent[path[-1]])
    return path[::-1]


def tree_candidates(cost, uni_label=None, k: int = 8,
                    return_deltas: bool = False):
    """The greedy MST plus its cheapest 1-edge-swap spanning-tree
    neighbours. For every non-tree pair (u, v) ascending and every edge
    (a, b) of the tree's u-v path, from u to v, the swap removes (a, b) and
    inserts (u, v) in its cheaper orientation; swaps are ranked by their
    local cost delta sym[u, v] - sym[a, b] (a stable sort: equal deltas keep
    that enumeration order) and deduplicated as edge sets.

    Returns a list of at most `k` (P-1, 2) int64 edge arrays (labels from
    `uni_label`), the MST first; with `return_deltas` also each one's delta
    (0.0 for the MST). numpy on the host, float64."""
    cost = np.asarray(cost, dtype=np.float64)
    p = cost.shape[0]
    base = mst(cost, uni_label=None, keep_index=True)
    deltas = [0.0]
    if p <= 2 or len(base) < p - 1:
        out = [base]
    else:
        sym = np.minimum(cost, cost.T)
        in_tree = {frozenset((int(a), int(b))) for a, b in base}
        swaps = []  # (delta, out_edge, in_pair): every path edge is a swap
        for u in range(p):
            for v in range(u + 1, p):
                if frozenset((u, v)) in in_tree:
                    continue
                path = _tree_path(base, p, u, v)
                for a, b in zip(path[:-1], path[1:]):
                    swaps.append((sym[u, v] - sym[a, b], (a, b), (u, v)))
        swaps.sort(key=lambda s: s[0])

        out, seen = [base], {frozenset(map(tuple, np.sort(base, axis=1)))}
        for delta, (a, b), (u, v) in swaps:
            if len(out) >= k:
                break
            edges = [e for e in base.tolist()
                     if {int(e[0]), int(e[1])} != {a, b}]
            edges.append([u, v] if cost[u, v] <= cost[v, u] else [v, u])
            arr = np.asarray(edges, dtype=np.int64)
            key = frozenset(map(tuple, np.sort(arr, axis=1)))
            if key in seen:
                continue
            seen.add(key)
            out.append(arr)
            deltas.append(float(delta))
    if uni_label is not None:
        uni_label = np.asarray(uni_label)
        out = [uni_label[t] for t in out]
    if return_deltas:
        return out, deltas
    return out
