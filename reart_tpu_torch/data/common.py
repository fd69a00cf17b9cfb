"""Shared dataset utilities (host-side, numpy; the port's own copy of
reart_tpu/data/common.py).

Parity target: utils/dataset_utils.py of the reference, including the
gpickle GT-graph loader with its module-aliasing shim (the GT graphs were
pickled against a `dataset.merge.Node` class; we register a compatible
class under that module path before unpickling — dataset_utils.py:91-109).
"""

from __future__ import annotations

import os
import pickle
import sys
import types

import numpy as np


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + unit-max-norm scale. (dataset_utils.py:7-12)"""
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


def load_state(load_path: str):
    """state_*.pkl -> (pc (N, 3), part_id (N,)). (dataset_utils.py:15-20)"""
    with open(load_path, "rb") as f:
        state = pickle.load(f)
    return state["pc"], state["part_id"]


def load_pose(load_path: str) -> dict:
    """pose_*.pkl -> {part_id: 4x4}. (dataset_utils.py:23-26)"""
    with open(load_path, "rb") as f:
        return pickle.load(f)


def get_rel_pose(pose_cano2src: dict, pose_cano2tgt: dict) -> dict:
    """Per-part src->tgt pose. (dataset_utils.py:35-39)"""
    return {
        pid: pose_cano2tgt[pid] @ np.linalg.inv(pose_cano2src[pid])
        for pid in pose_cano2src.keys()
    }


def pose_identity_like(pose_dict: dict) -> dict:
    return {pid: np.eye(4) for pid in pose_dict.keys()}


def load_normalize_dict(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def sparse_sample_novel_state(cano_pc, gt_cano_part, cano_pose, novel_pose,
                              sparse_sample_per_part: int = 1) -> dict:
    """Sparse per-part correspondences for IK retargeting, with the
    reference's FIXED point choice (indices 10..10+k per part —
    dataset_utils.py:74-75, "fix retarget point index")."""
    unique_part_ids = sorted(set(np.asarray(gt_cano_part).tolist()))
    pc_transform = np.empty_like(cano_pc)
    pose_cano2novel = get_rel_pose(cano_pose, novel_pose)
    pose_list = []
    num_sparse = sparse_sample_per_part * len(unique_part_ids)
    sparse_pc_0 = np.empty((num_sparse, 3))
    sparse_pc_1 = np.empty_like(sparse_pc_0)
    sparse_part_id = np.empty(num_sparse)
    start = 0
    for part_id in unique_part_ids:
        pose = pose_cano2novel[part_id]
        pose_list.append(pose)
        pc_idx = gt_cano_part == part_id
        points = cano_pc[pc_idx, :]
        homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
        pc_transform[pc_idx, :] = (homo @ pose.T)[:, :3]

        assert len(points) > 10 + sparse_sample_per_part
        choose = 10 + np.arange(sparse_sample_per_part)
        pts = points[choose, :]
        sparse_pc_0[start:start + sparse_sample_per_part] = pts
        sparse_part_id[start:start + sparse_sample_per_part] = part_id
        homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        sparse_pc_1[start:start + sparse_sample_per_part] = (homo @ pose.T)[:, :3]
        start += sparse_sample_per_part

    return {
        "gt_novel_pose": np.stack(pose_list).astype("float32"),
        "gt_sparse_part": sparse_part_id,
        "novel_pc": pc_transform,
        "sparse_cano_pc": sparse_pc_0,
        "sparse_novel_pc": sparse_pc_1,
    }


class Node:
    """Unpickle shim for the GT graphs (originally dataset.merge.Node)."""

    def __init__(self, link_names):
        self.link_names = link_names


def _register_unpickle_shim():
    mod = sys.modules.get("dataset.merge")
    if mod is None:
        mod = types.ModuleType("dataset.merge")
        sys.modules["dataset.merge"] = mod
        pkg = sys.modules.get("dataset")
        if pkg is None:
            pkg = types.ModuleType("dataset")
            sys.modules["dataset"] = pkg
        pkg.merge = mod
    if not hasattr(mod, "Node"):
        mod.Node = Node


def load_part_mapping(load_path: str):
    with open(load_path, "rb") as f:
        part_dict = pickle.load(f)
    return part_dict["face_part_mapping"], part_dict["node_part_mapping"]


def search_part_id(link_names, node_part_mapping: dict) -> int:
    for part_id, node_links in node_part_mapping.items():
        if sorted(link_names) == sorted(node_links):
            return part_id
    raise ValueError(f"{link_names} not found in part mapping!")


def load_gt_graph(graph_root_path: str):
    """GT kinematic tree for TED eval. Returns (nx.DiGraph over part ids,
    edge list (child, parent)). (dataset_utils.py:91-109) A graph.gpickle
    is a pickled networkx graph, so networkx is imported here and nowhere
    else in the package."""
    import networkx as nx

    _register_unpickle_shim()
    graph_path = os.path.join(graph_root_path, "graph.gpickle")
    mapping_path = os.path.join(graph_root_path, "part_mapping.pkl")
    assert os.path.exists(graph_path)
    assert os.path.exists(mapping_path)
    with open(graph_path, "rb") as f:
        graph = pickle.load(f)
    _, node_part_mapping = load_part_mapping(mapping_path)
    for node in graph.nodes:
        node.part_id = search_part_id(node.link_names, node_part_mapping)
    gt_edges = [(c.part_id, p.part_id) for c, p in graph.edges]
    gt_graph = nx.from_edgelist(gt_edges, create_using=nx.DiGraph())
    return gt_graph, gt_edges
