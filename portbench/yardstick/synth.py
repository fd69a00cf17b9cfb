"""The benchmark's inputs: articulated sequences made from a seed.

A frozen copy of `make_robot_sample` and of the view maker behind
`make_sapien_scene` (reart_tpu_torch/data/synth.py at the commit that added
this benchmark), kept here so that a later change to the program cannot
change what the benchmark feeds it. The sapien views are returned in memory
instead of written to disk; the points, parts and motions are the same.

The six-part table: a static body, a lid, a drawer, a door, a slider tray
and a top flap (three revolute and two prismatic joints), each part's
points drawn uniformly from its box.
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


# (box lo, box hi, motion kind, motion parameter) per part; part 0 is static
PARTS = (
    ((-0.6, -0.4, -0.3), (0.6, 0.4, 0.3), "static", None),
    ((-0.6, -0.4, 0.3), (0.6, 0.4, 0.45), "revolute",
     (0.10, (-0.6, 0.0, 0.3))),
    ((-0.5, 0.4, -0.25), (0.5, 0.75, 0.0), "prismatic",
     (0.05, (0.0, 1.0, 0.0))),
    ((0.6, -0.4, -0.3), (0.75, 0.4, 0.25), "revolute",
     (-0.09, (0.6, -0.4, 0.0))),
    ((-0.45, -0.75, -0.2), (0.45, -0.4, 0.0), "prismatic",
     (0.04, (1.0, 0.0, 0.0))),
    ((-0.2, -0.15, 0.45), (0.2, 0.15, 0.6), "revolute",
     (0.12, (0.0, 0.0, 0.45))),
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
    out = np.empty_like(points)
    for pid, pose in poses.items():
        sel = part_id == pid
        out[sel] = _apply(pose, points[sel])
    return out


def robot_sample(n_frames: int, n_points: int, n_parts: int,
                 seed: int) -> dict:
    """The table as a robot sample (`make_robot_sample` with cano_idx 0 and
    resampled frames: each frame its own draw from the parts' volumes), in
    the form `cli.run_sample` takes: the observed clouds (complete_pc_list,
    pc_list without the canonical frame 0), the GT clouds (the canonical
    cloud carried by the GT poses: complete_gt_pc_list, the GT flow's
    anchors), parts, poses, the GT tree and the novel poses."""
    table = PARTS[:n_parts]
    rng = np.random.RandomState(seed)
    n_per = n_points // n_parts
    counts = [n_points - n_per * (n_parts - 1)] + [n_per] * (n_parts - 1)
    part_id = np.repeat(np.arange(n_parts), counts)

    def poses_at(v):
        return {p: _part_pose(kind, param, v)
                for p, (_, _, kind, param) in enumerate(table)}

    poses = [poses_at(v) for v in range(n_frames)]

    def draw():
        return np.concatenate([rng.uniform(lo, hi, (n, 3))
                               for (lo, hi, _, _), n in zip(table, counts)])

    rest = draw()
    clouds = []
    for v in range(n_frames):
        if v > 0:
            rest = draw()
        clouds.append(_carry(rest, part_id, poses[v]))
    complete_pc = np.asarray(clouds, np.float32)
    cano = complete_pc[0]
    parts = sorted(poses[0])
    inv0 = {p: np.linalg.inv(poses[0][p]) for p in parts}
    rel = [{p: pose[p] @ inv0[p] for p in parts} for pose in poses]
    gt = np.stack([_carry(cano, part_id, r) for r in rel]).astype(np.float32)
    return {
        "cano_pc": cano,
        "gt_cano_part": part_id,
        "gt_flow_list": gt[1:] - gt[:-1],
        "gt_pc_list": gt[1:],
        "pc_list": complete_pc[1:],
        "gt_pose_list": np.stack([np.stack([r[p] for p in parts])
                                  for r in rel]).astype(np.float32),
        "complete_pc_list": complete_pc,
        "complete_gt_pc_list": gt,
        "complete_gt_part_list": np.stack([part_id] * n_frames),
        "gt_edges": [(p, 0) for p in range(1, n_parts)],
        "pose_list": poses,
        "cano_idx": 0,
        "novel_pose_list": [poses_at(0.5 * n_frames),
                            poses_at(n_frames + 0.5)],
    }


def sapien_views(n_views: int, n_points: int, n_parts: int, seed: int,
                 cam_rot: float = 0.06, cam_trans: float = 0.03,
                 rate_scale: float = 1.0) -> np.ndarray:
    """One mbs-sapien scene's views (`make_sapien_scene`'s scene 0): pc
    (V, N, 3) float32, every view the same volume-sampled points moved by
    the parts' motions and seen from a camera that turns by cam_rot and
    slides by cam_trans a view."""
    rng = np.random.RandomState(seed)
    n_per = n_points // n_parts
    clouds, seg = [], []
    for pid, (lo, hi, _, _) in enumerate(PARTS[:n_parts]):
        n = n_per if pid else n_points - n_per * (n_parts - 1)
        clouds.append(rng.uniform(lo, hi, (n, 3)))
        seg.append(np.full(n, pid + 1))
    cano = np.concatenate(clouds).astype(np.float64)
    segm1 = np.concatenate(seg)
    homo = np.concatenate([cano, np.ones((len(cano), 1))], 1)
    pcs = []
    for v in range(n_views):
        cam = _rotz4(cam_rot * v) @ _trans4([cam_trans * v,
                                             -cam_trans * v, 0.0])
        world = homo.copy()
        for pid, (_, _, kind, param) in enumerate(PARTS[:n_parts]):
            m = _part_pose(kind, param, v * rate_scale)
            sel = segm1 == pid + 1
            world[sel] = homo[sel] @ m.T
        pcs.append((world @ np.linalg.inv(cam).T)[:, :3].astype(np.float32))
    return np.stack(pcs)


def fit_inputs(config: dict, seed: int) -> dict:
    """The fit's inputs for a configuration's `data` block: cano (N, 3),
    frames (T-1, N, 3), and the flow anchors of each consecutive pair,
    anchors (T-1, M, 3) and flows (T-1, M, 3). robot_table: GT flow, the
    canonical cloud carried by the GT poses (`--flow_provider gt`);
    sapien_table: the scene's flow file at confidence 1, every point of
    view t with its motion to view t + 1 (`--flow_file`)."""
    data = config["data"]
    n_frames, n_points = config["n_frames"], config["num_points"]
    if data["generator"] == "robot_table":
        seq = robot_sample(n_frames, n_points, data["n_parts"], seed)
        pcs, anchors = seq["complete_pc_list"], seq["complete_gt_pc_list"]
    elif data["generator"] == "sapien_table":
        pcs = sapien_views(n_frames, n_points, data["n_parts"], seed,
                           data["cam_rot"], data["cam_trans"])
        anchors = pcs
    else:
        raise ValueError(f"unknown data generator {data['generator']!r}")
    return {"cano": pcs[0], "frames": pcs[1:],
            "anchors": anchors[:-1].copy(),
            "flows": (anchors[1:] - anchors[:-1]).astype(np.float32)}
