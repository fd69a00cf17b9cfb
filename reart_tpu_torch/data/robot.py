"""Robot sequence loader (nao-style pose/state pickles; the port's own copy
of reart_tpu/data/robot.py).

Parity target: dataset/dataset_robot.py of the reference. Directory layout:
state_{i}.pkl ({pc, part_id}), pose_{i}.pkl ({part_id: 4x4}, i >= 1),
novel_pose_{i}.pkl, plus graph.gpickle / part_mapping.pkl for GT structure.
An identity pose is inserted for frame 0 (dataset_robot.py:43).
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from reart_tpu_torch.data.common import (
    get_rel_pose,
    load_pose,
    load_state,
    pose_identity_like,
)


def _index_of(path: str) -> int:
    return int(re.split(r"[_.]", os.path.basename(path))[-2])


class RobotSequence:
    def __init__(self, seq_path: str, num_points: int = 4096, cano_idx: int = 0):
        self.seq_path = seq_path
        self.cat = seq_path.rstrip("/").split("/")[-1]
        self.num_points = num_points
        self.cano_idx = cano_idx

        pose_files = sorted(
            glob.glob(os.path.join(seq_path, "pose_*.pkl")), key=_index_of
        )
        if not pose_files:
            raise FileNotFoundError(
                f"no pose_*.pkl under {seq_path!r} — expected a robot sequence "
                "directory (state_i.pkl / pose_i.pkl); pass --seq_path"
            )
        novel_files = sorted(
            glob.glob(os.path.join(seq_path, "novel_pose_*.pkl")), key=_index_of
        )

        self.pc_path_list = [os.path.join(seq_path, "state_0.pkl")]
        self.pose_list = []
        for pose_file in pose_files:
            idx = _index_of(pose_file)
            self.pc_path_list.append(os.path.join(seq_path, f"state_{idx}.pkl"))
            self.pose_list.append(load_pose(pose_file))
        self.novel_pose_list = [load_pose(f) for f in novel_files]
        self.pose_list.insert(0, pose_identity_like(self.pose_list[0]))
        assert len(self.pc_path_list) == len(self.pose_list)

    def __len__(self):
        return 1

    def __getitem__(self, item) -> dict:
        complete_pc_list, complete_gt_part_list = [], []
        for pc_path in self.pc_path_list:
            pc, part = load_state(pc_path)
            if self.num_points < len(pc):
                # deterministic prefix crop, as the reference does
                pc = pc[: self.num_points]
                part = part[: self.num_points]
            complete_pc_list.append(pc)
            complete_gt_part_list.append(part)
        complete_pc_list = np.stack(complete_pc_list).astype("float32")
        complete_gt_part_list = np.stack(complete_gt_part_list)

        cano_pc = complete_pc_list[self.cano_idx]
        gt_cano_part = complete_gt_part_list[self.cano_idx]
        src_pose = self.pose_list[self.cano_idx]
        unique_part_ids = list(set(complete_gt_part_list[0].tolist()))

        complete_pc_transform_list, gt_pose_list = [], []
        for tgt_pose in self.pose_list:
            pc_transform = np.empty_like(cano_pc)
            pose_src2tgt = get_rel_pose(src_pose, tgt_pose)
            per_part = []
            for part_id in unique_part_ids:
                pose = pose_src2tgt[part_id]
                per_part.append(pose)
                pc_idx = gt_cano_part == part_id
                pts = cano_pc[pc_idx, :]
                homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
                pc_transform[pc_idx, :] = (homo @ pose.T)[:, :3]
            gt_pose_list.append(np.stack(per_part).astype("float32"))
            complete_pc_transform_list.append(pc_transform)
        complete_pc_transform_list = np.stack(complete_pc_transform_list).astype("float32")
        gt_flow_list = complete_pc_transform_list[1:] - complete_pc_transform_list[:-1]
        gt_pose_list = np.stack(gt_pose_list).astype("float32")

        c = self.cano_idx
        pc_list = np.concatenate(
            (complete_pc_list[:c], complete_pc_list[c + 1:]), axis=0
        )
        pc_transform_list = np.concatenate(
            (complete_pc_transform_list[:c], complete_pc_transform_list[c + 1:]),
            axis=0,
        )
        return {
            "cano_pc": cano_pc,
            "gt_cano_part": gt_cano_part,
            "gt_flow_list": gt_flow_list,
            "gt_pc_list": pc_transform_list,
            "pc_list": pc_list,
            "gt_pose_list": gt_pose_list,
            "complete_pc_list": complete_pc_list,
            "complete_gt_pc_list": complete_pc_transform_list,
            "complete_gt_part_list": complete_gt_part_list,
        }
