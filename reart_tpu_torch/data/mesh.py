"""Mesh reading and surface sampling (numpy; the port's own copy of
reart_tpu/data/mesh.py, without its optional trimesh loader).

The real-scan sequences are mesh files, one per frame. Two formats are read
directly:

  * GLB (binary glTF 2.0): the JSON and BIN chunks; the first mesh
    primitive's POSITION accessor and indices, moved by the transform of the
    first node that references the mesh;
  * OBJ: `v` and `f` lines, polygons fan-triangulated.

Sampling is area-weighted and uniform over each triangle, from a
RandomState, so a sequence samples the same points in both packages.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_GLTF_CTYPES = {5120: "b", 5121: "B", 5122: "h", 5123: "H", 5125: "I",
                5126: "f"}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def load_glb(path: str):
    """(vertices (V, 3) float64, faces (F, 3) int64) of the first triangle
    primitive of a .glb file."""
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"{path}: not a GLB file")
        chunks = {}
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            clen, ctype = struct.unpack("<II", head)
            chunks[ctype] = f.read(clen)
    gltf = json.loads(chunks[0x4E4F534A].decode("utf-8"))
    binbuf = chunks.get(0x004E4942, b"")

    def read_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        ncomp = _GLTF_NCOMP[acc["type"]]
        fmt = _GLTF_CTYPES[acc["componentType"]]
        stride = view.get("byteStride") or ncomp * struct.calcsize(fmt)
        out = np.empty((acc["count"], ncomp),
                       dtype=np.float64 if fmt == "f" else np.int64)
        for i in range(acc["count"]):
            out[i] = struct.unpack_from(f"<{ncomp}{fmt}", binbuf,
                                        offset + i * stride)
        return out

    prim = gltf["meshes"][0]["primitives"][0]
    verts = read_accessor(prim["attributes"]["POSITION"]).astype(np.float64)
    if "indices" in prim:
        faces = read_accessor(prim["indices"]).reshape(-1, 3).astype(np.int64)
    else:
        faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    node_mat = _node_transform(gltf, 0)
    if node_mat is not None:
        verts = verts @ node_mat[:3, :3].T + node_mat[:3, 3]
    return verts, faces


def _node_transform(gltf, mesh_idx):
    """4x4 transform of the first node that references mesh `mesh_idx`
    (its matrix, or scale, then rotation, then translation), or None."""
    for node in gltf.get("nodes", []):
        if node.get("mesh") != mesh_idx:
            continue
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m[:3, :3] *= np.asarray(node["scale"])
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y)],
            ])
            m[:3, :3] = r @ m[:3, :3]
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m
    return None


def load_obj(path: str):
    """(vertices (V, 3) float64, faces (F, 3) int64) of an OBJ file."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def load_mesh(path: str):
    """(vertices, faces) of a .glb or .obj file."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "glb":
        return load_glb(path)
    if ext == "obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: .{ext} (glb and obj are read)")


def sample_surface(verts: np.ndarray, faces: np.ndarray, count: int,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """`count` points uniform over the surface: triangles drawn by area,
    then uniform barycentric coordinates."""
    if rng is None:
        rng = np.random.RandomState(0)
    tri = verts[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    choice = rng.choice(len(faces), size=count, p=area / area.sum())
    r1 = np.sqrt(rng.uniform(size=(count, 1)))
    r2 = rng.uniform(size=(count, 1))
    a, b, c = tri[choice, 0], tri[choice, 1], tri[choice, 2]
    return (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
