"""Real-scan sequence loader: mesh frames sampled into clouds, no GT (the
port's own copy of reart_tpu/data/real.py).

Every mesh file of the directory is a frame, ordered by the number after
its last underscore (`scan_3.obj`). The canonical mesh's vertices give the
normalisation of the correspondence features (centroid, 1 / bbox
diagonal); each frame is sampled to `num_points` surface points from one
RandomState(seed), frame after frame.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from reart_tpu_torch.data.mesh import load_mesh, sample_surface


def normalize_stats(verts: np.ndarray):
    """(centroid, scale): the vertices' mean and 1 / |bbox diagonal|."""
    vmax, vmin = verts.max(axis=0), verts.min(axis=0)
    centroid = verts.mean(axis=0)
    return centroid, np.asarray(1.0 / np.linalg.norm(vmax - vmin))


class RealSequence:
    def __init__(self, seq_dir: str, num_points: int = 4096,
                 cano_idx: int = 0, seed: int = 0):
        self.seq_dir = seq_dir
        self.num_points = num_points
        self.cano_idx = cano_idx
        self._seed = seed
        files = sorted(
            glob.glob(os.path.join(seq_dir, "*.*")),
            key=lambda f: int(os.path.basename(f).split(".")[0]
                              .split("_")[-1]))
        if not files:
            raise FileNotFoundError(f"no mesh frames in {seq_dir}")
        self.mesh_list = [load_mesh(f) for f in files]
        self.centroid, self.scale = normalize_stats(
            self.mesh_list[cano_idx][0])

    def __len__(self):
        return 1

    def __getitem__(self, item) -> dict:
        rng = np.random.RandomState(self._seed)
        complete = np.stack([
            sample_surface(v, f, self.num_points, rng)
            for v, f in self.mesh_list
        ]).astype("float32")
        c = self.cano_idx
        return {
            "cano_pc": complete[c],
            "pc_list": np.concatenate([complete[:c], complete[c + 1:]], 0),
            "complete_pc_list": complete,
        }
