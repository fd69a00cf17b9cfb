"""Articulated scenes made in memory, in robot sample form: the dict that
`RobotSequence.__getitem__` returns, plus the GT tree as `gt_edges`
((child, parent) pairs), so a run needs no files.

`make_robot_sample` builds the six-part table of reart_tpu/data/synth.py
(static body, lid, drawer, door, slider tray, top flap: three revolute and
two prismatic joints) in the world frame; `make_toy_robot_sample` the
three-part robot of the command-line tests (a base and two hinged arms);
`make_offset_hinge_sample` the tree search's three-part robot, whose arm
hinges sit away from the origin.

A sample also carries what inverse kinematics reads off a RobotSequence,
in its form: `pose_list` (per frame {part: 4x4 world pose}, frame 0 the
identity), `cano_idx` and `novel_pose_list` (poses outside the sequence).

`write_robot_sequence` puts a sample on disk as the state / pose pickles a
`RobotSequence` reads, and `write_normalize_file` the normalisation pickle
of the correspondence model (`--normalize_file`), so the `corr` subcommand
can train on a scene made here.

The other two domains get scenes on disk in their own formats:
`make_sapien_scene` writes the part table as an mbs-sapien scene (views in
a moving camera's frame, a GT flow file for `--flow_file`), and
`write_real_scene` an OBJ sequence of a body with a hinged flap and a
slider, the scans of the `real` subcommand.
"""

from __future__ import annotations

import json
import os
import pickle

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


def make_offset_hinge_sample(n_per: int = 120, n_frames: int = 4,
                             seed: int = 3, cano_idx: int = 0) -> dict:
    """A body and two arms whose z hinges sit at x = -/+0.45, away from the
    origin: a chain tree (one arm under the other) would have to express
    the second arm's motion through the first arm's screw, which no fixed
    screw can, so the topology matters. Arms are children of the body."""
    rs = np.random.RandomState(seed)
    body = rs.uniform([-0.3, -0.4, -0.15], [0.3, 0.4, 0.15], (n_per, 3))
    arm_l = rs.uniform([-1.0, 0.1, -0.1], [-0.45, 0.35, 0.1], (n_per, 3))
    arm_r = rs.uniform([0.45, 0.1, -0.1], [1.0, 0.35, 0.1], (n_per, 3))
    cano = np.concatenate([body, arm_l, arm_r])
    part_id = np.repeat([0, 1, 2], n_per)

    def poses_at(i):
        return {0: np.eye(4), 1: _pivot_rotz(0.3 * i, (-0.45, 0.2, 0.0)),
                2: _pivot_rotz(-0.25 * i, (0.45, 0.2, 0.0))}

    poses = [poses_at(i) for i in range(n_frames)]
    clouds = [_carry(cano, part_id, pose) for pose in poses]
    return robot_sample(clouds, [part_id] * n_frames, poses,
                        [(1, 0), (2, 0)], cano_idx, [poses_at(5)])


def write_robot_sequence(seq_dir: str, sample: dict) -> None:
    """The sample as a robot sequence directory: state_{i}.pkl ({pc,
    part_id}) for every frame, pose_{i}.pkl for i >= 1 and
    novel_pose_{j}.pkl. No graph.gpickle: a run from these files takes the
    GT tree from the sample's `gt_edges`."""
    os.makedirs(seq_dir, exist_ok=True)

    def dump(name, obj):
        with open(os.path.join(seq_dir, name), "wb") as f:
            pickle.dump(obj, f)

    clouds, parts = sample["complete_pc_list"], sample["complete_gt_part_list"]
    for i in range(clouds.shape[0]):
        dump(f"state_{i}.pkl", {"pc": clouds[i], "part_id": parts[i]})
        if i > 0:
            dump(f"pose_{i}.pkl", sample["pose_list"][i])
    for j, pose in enumerate(sample["novel_pose_list"]):
        dump(f"novel_pose_{j}.pkl", pose)


def unit_ball_normalization(sample: dict):
    """(centroid (3,) float32, scale): (cloud - centroid) * scale carries
    every frame of the sample into the unit ball."""
    flat = sample["complete_pc_list"].reshape(-1, 3)
    centroid = flat.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(flat - centroid, axis=-1).max())
    return centroid, 1.0 / max(radius, 1e-6)


def write_normalize_file(path: str, seq_dir: str, sample: dict) -> None:
    """The --normalize_file of a scene: {sequence name: {centroid, scale}}
    with the sample's unit-ball normalisation."""
    centroid, scale = unit_ball_normalization(sample)
    with open(path, "wb") as f:
        pickle.dump({seq_dir.rstrip("/").split("/")[-1]:
                     {"centroid": centroid, "scale": scale}}, f)


def make_sapien_scene(root: str, n_views: int = 8, n_points: int = 4096,
                      n_parts: int = 6, seed: int = 0,
                      cam_rot: float = 0.06, cam_trans: float = 0.03,
                      n_scenes: int = 1, rate_step: float = 0.15) -> str:
    """Write mbs-sapien scenes of the part table under `root` and return
    root: <root>/meta.json {"test": [0, ..., n_scenes - 1]}; for scene k
    <root>/data/<k:06d>.npz with pc (V, N, 3) float32 in each view's camera
    frame, segm (V, N) 1-based and trans {"cam": [V 4x4], 1..P: [V 4x4]}
    (world-frame part motions), and <root>/flow_<k>.npz with the GT flow of
    consecutive views and confidence 1 (the `--flow_file` of the sapien
    subcommand: `flow_{idx}.npz` for `--batch_seq`); <root>/flow.npz is
    scene 0's.

    n_parts (2..6) takes a prefix of the table (4 and more keep both
    prismatic joints); every view observes the same volume-sampled points.
    View v's camera is rotz(cam_rot * v) after a translation of
    cam_trans * v along (+x, -y): the raw views are not aligned. Scene k
    draws its points from seed + k and moves its joints at (1 + k *
    rate_step) times the table's rates, so the scenes differ; scene 0 is
    the one scene of n_scenes=1."""
    assert 2 <= n_parts <= len(_PARTS)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    for k in range(n_scenes):
        pcs, segms, trans = _sapien_views(
            np.random.RandomState(seed + k), n_views, n_points, n_parts,
            cam_rot, cam_trans, 1.0 + k * rate_step)
        np.savez(os.path.join(root, "data", "%06d.npz" % k), pc=pcs,
                 segm=segms, trans=np.asarray(trans, dtype=object))
        flow = (pcs[1:] - pcs[:-1]).astype(np.float32)
        names = [f"flow_{k}.npz"] + (["flow.npz"] if k == 0 else [])
        for name in names:
            np.savez(os.path.join(root, name), flow=flow,
                     conf=np.ones(flow.shape[:2], np.float32))
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"test": list(range(n_scenes))}, f)
    return root


def _sapien_views(rng, n_views, n_points, n_parts, cam_rot, cam_trans,
                  rate_scale):
    """One scene's views: (pc (V, N, 3) float32, segm (V, N), trans)."""
    n_per = n_points // n_parts
    clouds, seg = [], []
    for pid, (lo, hi, _, _) in enumerate(_PARTS[:n_parts]):
        n = n_per if pid else n_points - n_per * (n_parts - 1)
        clouds.append(rng.uniform(lo, hi, (n, 3)))
        seg.append(np.full(n, pid + 1))
    cano = np.concatenate(clouds).astype(np.float64)
    segm1 = np.concatenate(seg)

    pcs, segms = [], []
    trans = {"cam": [], **{p: [] for p in range(1, n_parts + 1)}}
    homo = np.concatenate([cano, np.ones((len(cano), 1))], 1)
    for v in range(n_views):
        cam = _rotz4(cam_rot * v) @ _trans4([cam_trans * v,
                                             -cam_trans * v, 0.0])
        trans["cam"].append(cam)
        world = homo.copy()
        for pid, (_, _, kind, param) in enumerate(_PARTS[:n_parts]):
            m = _part_pose(kind, param, v * rate_scale)
            trans[pid + 1].append(m)
            sel = segm1 == pid + 1
            world[sel] = homo[sel] @ m.T
        pcs.append((world @ np.linalg.inv(cam).T)[:, :3].astype(np.float32))
        segms.append(segm1)
    return np.stack(pcs), np.stack(segms), trans


def _box_mesh(lo, hi):
    """The 8 corners and 12 outward triangles of an axis-aligned box."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    corners = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0],
                        [x0, y1, z0], [x0, y0, z1], [x1, y0, z1],
                        [x1, y1, z1], [x0, y1, z1]], float)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                      [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    return corners, faces


def write_real_scene(out_dir: str, n_frames: int = 6) -> str:
    """Write a real-scan sequence, `scan_{i}.obj` for i < n_frames: a body
    box, a flap hinged about y at its near edge (0.22 rad a frame) and a
    slider moving along +x (0.12 a frame); returns out_dir. The geometry of
    scripts/make_real_scene.py."""
    os.makedirs(out_dir, exist_ok=True)
    body_v, body_f = _box_mesh((-0.5, -0.3, -0.25), (0.5, 0.3, 0.25))
    flap_v, flap_f = _box_mesh((0.5, -0.25, 0.18), (1.05, 0.25, 0.26))
    slider_v, slider_f = _box_mesh((-0.45, -0.28, -0.45), (0.35, 0.28, -0.27))
    pivot = np.array([0.5, 0.0, 0.22])
    for i in range(n_frames):
        c, s = np.cos(0.22 * i), np.sin(0.22 * i)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        verts = np.concatenate([body_v, (flap_v - pivot) @ rot.T + pivot,
                                slider_v + np.array([0.12 * i, 0.0, 0.0])])
        faces = np.concatenate([body_f, flap_f + len(body_v),
                                slider_f + len(body_v) + len(flap_v)])
        lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
        with open(os.path.join(out_dir, f"scan_{i}.obj"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return out_dir
