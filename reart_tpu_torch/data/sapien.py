"""SAPIEN articulated-object dataset loader (mbs-sapien layout; the port's
own copy of reart_tpu/data/sapien.py).

Directory layout: <base>/meta.json with a "test" id list, <base>/data/
%06d.npz holding pc (V, N, 3), segm (V, N) 1-based, and trans, an object
dict {'cam': [V 4x4], 1..P: [V 4x4]} of camera and world-frame part
motions. The per-part pose carrying view a onto view b is plain 4x4
algebra: cam_b^-1 @ motion_b @ motion_a^-1 @ cam_a.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _inv(m: np.ndarray) -> np.ndarray:
    """Inverse of a rigid 4x4."""
    r, t = m[:3, :3], m[:3, 3]
    out = np.eye(4, dtype=m.dtype)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def _apply(m: np.ndarray, pc: np.ndarray) -> np.ndarray:
    return pc @ m[:3, :3].T + m[:3, 3]


def compute_unalign(base_pc, base_segms, base_cam, base_motions, dest_cam,
                    dest_motions):
    """Per-part pose carrying view `base` onto view `dest`. Returns (moved
    pc, (P, 4, 4) float32 pose list)."""
    final_pc = np.empty_like(base_pc)
    pose_list = []
    inv_dest_cam = _inv(dest_cam)
    for part_id, (bm, dm) in enumerate(zip(base_motions, dest_motions)):
        pose = inv_dest_cam @ dm @ _inv(bm) @ base_cam
        mask = base_segms == part_id
        final_pc[mask] = _apply(pose, base_pc[mask])
        pose_list.append(pose)
    return final_pc, np.stack(pose_list).astype("float32")


class SapienDataset:
    def __init__(self, base_folder: str, cano_idx: int = 0):
        self.base_folder = base_folder
        with open(os.path.join(base_folder, "meta.json")) as f:
            self.meta = json.load(f)
        self.data_ids = self.meta["test"]
        self.cano_idx = cano_idx

    def __len__(self):
        return len(self.data_ids)

    def _raw(self, idx: int):
        path = os.path.join(self.base_folder, "data",
                            "%06d.npz" % self.data_ids[idx])
        datum = np.load(path, allow_pickle=True)
        return (datum["pc"].astype(np.float32), datum["segm"],
                datum["trans"].item())

    def __getitem__(self, idx: int) -> dict:
        """The sequence's sample: canonical cloud and parts, the GT clouds
        (the canonical cloud carried to each view), GT poses and flows, the
        views' own clouds and parts, and `gt_full_flow`, the (V*V, N, 3) GT
        flow between every ordered view pair."""
        pcs, segms, trans = self._raw(idx)
        segms = segms - 1  # 0-based part ids
        n_parts = len(trans) - 1
        n_views = pcs.shape[0]
        cano = self.cano_idx

        def cam(v):
            return np.asarray(trans["cam"][v], np.float64)

        def motions(v):
            return [np.asarray(trans[t][v], np.float64)
                    for t in range(1, n_parts + 1)]

        cano_pc, gt_cano_part = pcs[cano], segms[cano]
        base_cam, base_motions = cam(cano), motions(cano)
        gt_pcs, gt_poses = [], []
        for i in range(n_views):
            pc_i, pose_i = compute_unalign(cano_pc, gt_cano_part, base_cam,
                                           base_motions, cam(i), motions(i))
            gt_pcs.append(pc_i)
            gt_poses.append(pose_i)
        full_flow = []
        for vi in range(n_views):
            for vj in range(n_views):
                pc_ij, _ = compute_unalign(pcs[vi], segms[vi], cam(vi),
                                           motions(vi), cam(vj), motions(vj))
                full_flow.append(pc_ij - pcs[vi])

        complete_gt = np.stack(gt_pcs).astype("float32")

        def drop_cano(arr):
            return np.concatenate([arr[:cano], arr[cano + 1:]], axis=0)

        return {
            "cano_pc": cano_pc,
            "gt_cano_part": gt_cano_part,
            "gt_flow_list": complete_gt[1:] - complete_gt[:-1],
            "gt_pc_list": drop_cano(complete_gt),
            "gt_pose_list": np.stack(gt_poses).astype("float32"),
            "pc_list": drop_cano(pcs),
            "complete_pc_list": pcs,
            "complete_gt_pc_list": complete_gt,
            "complete_gt_part_list": segms,
            "gt_full_flow": np.stack(full_flow),
        }
