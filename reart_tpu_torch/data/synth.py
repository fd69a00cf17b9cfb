"""Articulated scenes made in memory, in robot sample form: the dict that
`RobotSequence.__getitem__` returns, plus the GT tree as `gt_edges`
((child, parent) pairs), so a run needs no files.

`make_robot_sample` builds the six-part table of reart_tpu/data/synth.py
(static body, lid, drawer, door, slider tray, top flap: three revolute and
two prismatic joints) in the world frame; `make_toy_robot_sample` the
three-part robot of the command-line tests (a base and two hinged arms).

A sample also carries what inverse kinematics reads off a RobotSequence,
in its form: `pose_list` (per frame {part: 4x4 world pose}, frame 0 the
identity), `cano_idx` and `novel_pose_list` (poses outside the sequence).
"""

from __future__ import annotations

import numpy as np


def _rotz4(a):
    return np.array([
        [np.cos(a), -np.sin(a), 0, 0],
        [np.sin(a), np.cos(a), 0, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ])


def _trans4(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


def _pivot_rotz(a, pivot):
    return _trans4(pivot) @ _rotz4(a) @ _trans4(-np.asarray(pivot))


# (box lo, box hi, motion kind, motion parameter) per part; part 0 is the
# static body. Motion rates are per frame; over 8-10 frames each joint
# sweeps a bounded share of its range (lid ~40-50 deg, drawer ~0.35-0.45 of
# the body scale), as scans of one sequence do.
_PARTS = (
    ((-0.6, -0.4, -0.3), (0.6, 0.4, 0.3), "static", None),
    ((-0.6, -0.4, 0.3), (0.6, 0.4, 0.45), "revolute",
     (0.10, (-0.6, 0.0, 0.3))),                      # lid, back-edge hinge
    ((-0.5, 0.4, -0.25), (0.5, 0.75, 0.0), "prismatic",
     (0.05, (0.0, 1.0, 0.0))),                       # drawer, +y
    ((0.6, -0.4, -0.3), (0.75, 0.4, 0.25), "revolute",
     (-0.09, (0.6, -0.4, 0.0))),                     # door, front hinge
    ((-0.45, -0.75, -0.2), (0.45, -0.4, 0.0), "prismatic",
     (0.04, (1.0, 0.0, 0.0))),                       # slider tray, +x
    ((-0.2, -0.15, 0.45), (0.2, 0.15, 0.6), "revolute",
     (0.12, (0.0, 0.0, 0.45))),                      # top flap
)


def _part_pose(kind, param, v):
    if kind == "static":
        return np.eye(4)
    if kind == "revolute":
        rate, pivot = param
        return _pivot_rotz(rate * v, pivot)
    rate, axis = param
    return _trans4(rate * v * np.asarray(axis))


def _apply(pose, pts):
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (homo @ pose.T)[:, :3]


def _carry(points, part_id, poses):
    """Move each part's points by its pose: poses {part: 4x4}."""
    out = np.empty_like(points)
    for pid, pose in poses.items():
        sel = part_id == pid
        out[sel] = _apply(pose, points[sel])
    return out


def robot_sample(clouds, part_ids, poses, gt_edges, cano_idx: int = 0,
                 novel_poses=()):
    """The sample dict of a robot sequence. clouds (T, N, 3): the observed
    cloud of every frame; part_ids (T, N): their GT parts; poses: T dicts
    {part: 4x4 world pose}; gt_edges: (child, parent) part pairs;
    novel_poses: dicts like `poses` for the retargeting error."""
    complete_pc = np.asarray(clouds, np.float32)
    complete_part = np.asarray(part_ids)
    cano_pc = complete_pc[cano_idx]
    gt_cano_part = complete_part[cano_idx]
    parts = sorted(poses[0])
    inv_cano = {p: np.linalg.inv(poses[cano_idx][p]) for p in parts}
    rel = [{p: pose[p] @ inv_cano[p] for p in parts} for pose in poses]
    complete_gt = np.stack([_carry(cano_pc, gt_cano_part, r) for r in rel]
                           ).astype(np.float32)
    c = cano_idx
    drop = lambda x: np.concatenate((x[:c], x[c + 1:]), axis=0)
    return {
        "cano_pc": cano_pc,
        "gt_cano_part": gt_cano_part,
        "gt_flow_list": complete_gt[1:] - complete_gt[:-1],
        "gt_pc_list": drop(complete_gt),
        "pc_list": drop(complete_pc),
        "gt_pose_list": np.stack([np.stack([r[p] for p in parts])
                                  for r in rel]).astype(np.float32),
        "complete_pc_list": complete_pc,
        "complete_gt_pc_list": complete_gt,
        "complete_gt_part_list": complete_part,
        "gt_edges": [tuple(e) for e in gt_edges],
        "pose_list": list(poses),
        "cano_idx": cano_idx,
        "novel_pose_list": list(novel_poses),
    }


# the table's parts that rotate (body, lid, door, flap): a revolute-only
# kinematic model can hold them
REVOLUTE_PARTS = (0, 1, 3, 5)


def make_robot_sample(n_frames: int = 10, n_points: int = 4096,
                      n_parts: int = 6, seed: int = 0, cano_idx: int = 0,
                      resample: bool = True, parts=None) -> dict:
    """The articulated table as a robot sample: `n_parts` (2..6, a prefix
    of the part table) box-sampled rigid parts, or the rows `parts` of the
    table (the static body first), relabelled 0..P-1; every joint a child
    of the static body. With `resample` each frame's observed cloud is its
    own draw from the surfaces' volumes (frames of a scan share no points);
    without, every frame is the first cloud carried by the GT poses. The
    novel poses lie between two frames and past the last one."""
    if parts is None:
        parts = tuple(range(n_parts))
    table = [_PARTS[i] for i in parts]
    n_parts = len(table)
    assert 2 <= n_parts <= len(_PARTS) and parts[0] == 0
    rng = np.random.RandomState(seed)
    n_per = n_points // n_parts
    counts = [n_points - n_per * (n_parts - 1)] + [n_per] * (n_parts - 1)
    part_id = np.repeat(np.arange(n_parts), counts)

    def poses_at(v):
        return {p: _part_pose(kind, param, v)
                for p, (_, _, kind, param) in enumerate(table)}

    poses = [poses_at(v) for v in range(n_frames)]

    def draw():
        return np.concatenate([
            rng.uniform(lo, hi, (n, 3))
            for (lo, hi, _, _), n in zip(table, counts)])

    rest = draw()
    clouds = []
    for v in range(n_frames):
        if resample and v > 0:
            rest = draw()
        clouds.append(_carry(rest, part_id, poses[v]))
    return robot_sample(clouds, [part_id] * n_frames, poses,
                        [(p, 0) for p in range(1, n_parts)], cano_idx,
                        [poses_at(0.5 * n_frames), poses_at(n_frames + 0.5)])


def make_toy_robot_sample(n_per: int = 120, n_frames: int = 4,
                          seed: int = 0, cano_idx: int = 0) -> dict:
    """A base and two arms hinged about z, every frame the first cloud
    carried by the GT poses; arms are children of the base."""
    rs = np.random.RandomState(seed)
    base = rs.uniform([-0.3, -0.5, -0.2], [0.3, 0.5, 0.2], (n_per, 3))
    arm_l = rs.uniform([-1.0, 0.2, -0.1], [-0.3, 0.45, 0.1], (n_per, 3))
    arm_r = rs.uniform([0.3, 0.2, -0.1], [1.0, 0.45, 0.1], (n_per, 3))
    cano = np.concatenate([base, arm_l, arm_r])
    part_id = np.repeat([0, 1, 2], n_per)
    def poses_at(i):
        return {0: np.eye(4), 1: _rotz4(0.25 * i), 2: _rotz4(-0.2 * i)}

    poses = [poses_at(i) for i in range(n_frames)]
    clouds = [_carry(cano, part_id, pose) for pose in poses]
    return robot_sample(clouds, [part_id] * n_frames, poses,
                        [(1, 0), (2, 0)], cano_idx,
                        [poses_at(1.5), poses_at(n_frames + 0.5)])
