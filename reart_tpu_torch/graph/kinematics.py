"""Kinematic-tree construction (reart_tpu/graph/kinematics.py): the
relabelling that closes the relaxation run. `build_graph` and `to_dag`
belong to the kinematic stage."""

from __future__ import annotations

import numpy as np
import torch


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
