"""The artifacts' module (reart_tpu_torch/viz.py) against the JAX package's
(reart_tpu/viz.py) on the same numpy inputs: the part colours and the html
viewers exactly (the returned point sets, the files byte for byte, the
plotly branch's figures), the gif frames to what a renderer without
matplotlib can match: the projection to matplotlib's own within 0.5 px,
and on a full-width 4096-point cloud each frame's painted pixels (IoU of
the masks after a 2-px dilation) and their centroids. matplotlib runs only
on the JAX side; the port writes every artifact with it unimportable."""

import importlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from PIL import Image

from reart_tpu import viz as jax_viz
from reart_tpu_torch import viz
from reart_tpu_torch.data.synth import make_robot_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# frames against the JAX package's: the mask of pixels with any channel
# below MASK_LEVEL, both dilated by DILATE px, overlap at least MIN_IOU; the
# masks' centroids lie within CENTROID_PX (the whole frame) and
# PART_CENTROID_PX (each part drawn alone on the sequence's limits)
MASK_LEVEL = 240
DILATE = 2
MIN_IOU = 0.85
CENTROID_PX = 2.0
PART_CENTROID_PX = 3.0
# the projected points against matplotlib's transData of get_proj's
PROJECTION_PX = 0.5


def _cloud(n=200, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3).astype(np.float32), rng.randint(0, 3, n)


def _same_sets(got, ref):
    assert len(got) == len(ref)
    for (gp, gc), (rp, rc) in zip(got, ref):
        assert np.array_equal(gp, rp) and gp.dtype == rp.dtype
        assert np.array_equal(gc, rc) and gc.dtype == rc.dtype


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_jet_lut_is_matplotlibs():
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("jet")
    cmap(0.5)  # builds the table
    assert np.array_equal(viz.jet_lut(), cmap._lut[:viz.JET_N, :3])


@pytest.mark.parametrize("ids", [
    "contiguous", "non_contiguous", "single", "unsorted_repeats"])
def test_part_colors_exact(ids):
    rng = np.random.RandomState(3)
    if ids == "contiguous":  # 1 to 40 parts
        cases = [np.arange(n) for n in range(1, 41)]
    elif ids == "non_contiguous":
        cases = [np.array([0, 3, 17]), np.array([17, 3, 0, 3]),
                 np.array([-2, 5, 100, 7, 64])]
    elif ids == "single":
        cases = [np.array([4]), np.full(30, 9)]
    else:
        cases = [rng.randint(0, k, 300) for k in (2, 5, 13, 20, 33)]
    for labels in cases:
        got, ref = viz.part_colors(labels), jax_viz.part_colors(labels)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), labels


@pytest.mark.parametrize("gt", ["none", "same_cloud", "pc_gt"])
def test_vis_pc_matches_jax(gt, tmp_path):
    pc, part = _cloud()
    kw = {}
    if gt != "none":
        kw["gt_part"] = (part + 1) % 3
    if gt == "pc_gt":
        kw["pc_gt"] = _cloud(seed=1)[0]
    _same_sets(viz.vis_pc(pc, part, **kw), jax_viz.vis_pc(pc, part, **kw))
    paths = [str(tmp_path / f"{who}.html") for who in ("torch", "jax")]
    _same_sets(viz.vis_pc(pc, part, save_path=paths[0], **kw),
               jax_viz.vis_pc(pc, part, save_path=paths[1], **kw))
    _same_file(*paths)


def _structure_case(name):
    """(cloud, labels, joint_connection) of a tree shape."""
    rng = np.random.RandomState(7)
    if name == "antipodal":
        # the parent's centroid straight below the child's: the edge runs
        # along -z, where Rodrigues' formula degenerates
        child = rng.randn(50, 3) * 0.05 + [0.0, 0.0, 1.0]
        parent = rng.randn(50, 3) * 0.05
        parent += child.mean(0) - parent.mean(0) - [0.0, 0.0, 1.0]
        pc = np.concatenate([parent, child]).astype(np.float32)
        return pc, np.repeat([0, 1], 50), [[1, 0]]
    pc, _ = _cloud(240, seed=2)
    labels = np.repeat(np.arange(4), 60)
    pc += np.repeat(np.eye(4, 3) * 2.0, 60, axis=0).astype(np.float32)
    edges = {"chain": [[1, 0], [2, 1], [3, 2]],
             "star": [[1, 0], [2, 0], [3, 0]],
             # part 5 has no points: the edge is left out and printed
             "empty_edge": [[1, 0], [5, 1], [2, 0], [3, 5]]}[name]
    return pc, labels, edges


@pytest.mark.parametrize("shape", ["chain", "star", "antipodal",
                                   "empty_edge"])
def test_vis_structure_matches_jax(shape, tmp_path, capsys):
    pc, labels, edges = _structure_case(shape)
    got = viz.vis_structure(pc, labels, edges)
    printed = capsys.readouterr().out
    _same_sets(got, jax_viz.vis_structure(pc, labels, edges))
    assert capsys.readouterr().out == printed
    assert ("empty edge" in printed) == (shape == "empty_edge")
    if shape == "empty_edge":
        assert printed.splitlines() == [
            "empty edge 1-5: a part has no points",
            "empty edge 5-3: a part has no points"]
        assert len(got) == 3 and len(got[2][0]) == 2 * 50 * 100
    paths = [str(tmp_path / f"{who}.html") for who in ("torch", "jax")]
    viz.vis_structure(pc, labels, edges, save_path=paths[0])
    jax_viz.vis_structure(pc, labels, edges, save_path=paths[1])
    _same_file(*paths)


def _plotly_stub(written):
    """A stand-in `plotly.graph_objects` whose figures record their traces
    and layout into `written` when write_html is called."""
    go = types.ModuleType("plotly.graph_objects")

    class Figure:
        def __init__(self):
            self.traces, self.layout = [], None

        def add_trace(self, trace):
            self.traces.append(trace)

        def update_layout(self, **kw):
            self.layout = kw

        def write_html(self, path):
            written.append((os.path.basename(path), self.traces,
                            self.layout))

    go.Figure = Figure
    go.Scatter3d = lambda **kw: ("Scatter3d", kw)
    go.Surface = lambda **kw: ("Surface", kw)
    plotly = types.ModuleType("plotly")
    plotly.graph_objects = go
    return plotly, go


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    else:
        assert a == b


def test_plotly_branch_matches_jax(monkeypatch, tmp_path):
    """With a plotly in sys.modules both modules take their plotly branch,
    chosen when they are imported: the same traces and layouts."""
    written = {"torch": [], "jax": []}
    pc, part = _cloud()
    spc, slabels, sedges = _structure_case("star")
    try:
        for who, mod in (("torch", viz), ("jax", jax_viz)):
            plotly, go = _plotly_stub(written[who])
            monkeypatch.setitem(sys.modules, "plotly", plotly)
            monkeypatch.setitem(sys.modules, "plotly.graph_objects", go)
            importlib.reload(mod)
            assert mod.HAS_PLOTLY
            mod.vis_pc(pc, part, gt_part=part, name="pred",
                       save_path=str(tmp_path / "seg.html"))
            mod.vis_structure(spc, slabels, sedges,
                              save_path=str(tmp_path / "structure.html"))
    finally:
        monkeypatch.undo()
        importlib.reload(viz)
        importlib.reload(jax_viz)
    assert not viz.HAS_PLOTLY and not jax_viz.HAS_PLOTLY
    assert [w[0] for w in written["torch"]] == ["seg.html",
                                                "structure.html"]
    kinds = [t[0] for t in written["torch"][1][1]]
    assert kinds == ["Scatter3d"] * 5 + ["Surface"] * 3
    _same_tree(written["torch"], written["jax"])
    assert not os.listdir(tmp_path)  # the stub writes no file


# ---------------------------------------------------------------------------
# gifs
# ---------------------------------------------------------------------------

def _figure_as_render_frame(pc, lims):
    """The 3-D axes of reart_tpu/viz.py `_render_frame` (:138-145): the
    same figure, scatter, limits, axis off, tight layout, drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(4, 4), dpi=80)
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pc[:, 0], pc[:, 2], pc[:, 1], c=np.zeros((len(pc), 3)), s=2)
    ax.set_xlim(lims[0]); ax.set_ylim(lims[2]); ax.set_zlim(lims[1])
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    return fig, ax


@pytest.mark.parametrize("cloud", ["random", "flat", "offset"])
def test_projection_matches_matplotlib(cloud):
    from mpl_toolkits.mplot3d import proj3d
    import matplotlib.pyplot as plt

    pc = np.random.RandomState(11).uniform(-1, 1, (500, 3))
    if cloud == "flat":  # one coordinate constant: the axis widens its range
        pc[:, 2] = 0.25
    elif cloud == "offset":
        pc = pc * [0.1, 3.0, 0.7] + [5.0, -2.0, 40.0]
    lims = [(pc[:, i].min(), pc[:, i].max()) for i in range(3)]
    fig, ax = _figure_as_render_frame(pc, lims)
    try:
        xs, ys, zs = proj3d.proj_transform(pc[:, 0], pc[:, 2], pc[:, 1],
                                           ax.get_proj())
        ref = ax.transData.transform(np.column_stack([xs, ys]))
        assert tuple(ax.bbox.size) == pytest.approx((viz.FRAME_PX,) * 2)
    finally:
        plt.close(fig)
    x, y, depth, keep = viz.project(pc[:, [0, 2, 1]],
                                    (lims[0], lims[2], lims[1]))
    assert keep.all()
    assert np.abs(x - ref[:, 0]).max() <= PROJECTION_PX
    assert np.abs(y - ref[:, 1]).max() <= PROJECTION_PX
    np.testing.assert_allclose(depth, zs, rtol=0, atol=1e-9)


def _mask(frame):
    return (np.asarray(frame) < MASK_LEVEL).any(axis=-1)


def _dilate(mask, r=DILATE):
    padded = np.pad(mask, r)
    out = np.zeros_like(mask)
    h, w = mask.shape
    for dr in range(2 * r + 1):
        for dc in range(2 * r + 1):
            out |= padded[dr:dr + h, dc:dc + w]
    return out


def _centroid(mask):
    rows, cols = np.nonzero(mask)
    return np.array([rows.mean(), cols.mean()])


@pytest.fixture(scope="module")
def full_width_sequence():
    """Three frames of the articulated table at the full width: 4096
    points in 5 parts (sparse toys are too sensitive: antialiased fringes
    dominate their masks)."""
    sample = make_robot_sample(n_frames=3, n_points=4096, n_parts=5, seed=0)
    return sample["complete_gt_pc_list"], sample["gt_cano_part"]


@pytest.fixture(scope="module")
def jax_frames(full_width_sequence):
    pcs, part = full_width_sequence
    return jax_viz.vis_pc_seq(pcs, pred_part=part)


def test_frames_and_gif(full_width_sequence, jax_frames, tmp_path):
    pcs, part = full_width_sequence
    path = str(tmp_path / "recon.gif")
    frames = viz.vis_pc_seq(pcs, pred_part=part, save_path=path)
    assert len(frames) == len(jax_frames) == len(pcs)
    for got, ref in zip(frames, jax_frames):
        assert got.shape == ref.shape == (viz.FRAME_PX, viz.FRAME_PX, 3)
        assert got.dtype == ref.dtype == np.uint8
    with Image.open(path) as im:
        assert im.format == "GIF" and im.n_frames == len(pcs)
        assert im.info["loop"] == 0
        for k in range(im.n_frames):
            im.seek(k)
            assert im.size == (viz.FRAME_PX, viz.FRAME_PX)
            # ROADMAP §3 item 28: the 0.3 s a frame the JAX call asks for
            assert im.info["duration"] == viz.GIF_FRAME_MS == 300
    # one blue without labels, as the JAX package draws input.gif
    blue = viz.vis_pc_seq(pcs[:1])[0]
    colours = {tuple(c) for c in blue.reshape(-1, 3)} - {(255, 255, 255)}
    assert all(c[2] >= c[1] >= c[0] for c in colours)


def test_frames_match_jax_masks(full_width_sequence, jax_frames):
    pcs, part = full_width_sequence
    frames = viz.vis_pc_seq(pcs, pred_part=part)
    for got, ref in zip(frames, jax_frames):
        a, b = _dilate(_mask(got)), _dilate(_mask(ref))
        iou = (a & b).sum() / (a | b).sum()
        assert iou >= MIN_IOU, iou
        shift = np.abs(_centroid(_mask(got)) - _centroid(_mask(ref)))
        assert shift.max() <= CENTROID_PX, shift
    # each part drawn alone on the sequence's limits, by both renderers
    flat = pcs.reshape(-1, 3)
    lims = [(flat[:, i].min(), flat[:, i].max()) for i in range(3)]
    colors = viz.part_colors(part)
    for pc in pcs:
        for p in np.unique(part):
            sel = part == p
            got = viz.render_frame(pc[sel], colors[sel], lims)
            ref = jax_viz._render_frame(pc[sel], colors[sel], lims)
            shift = np.abs(_centroid(_mask(got)) - _centroid(_mask(ref)))
            assert shift.max() <= PART_CENTROID_PX, (p, shift)


def test_every_artifact_without_matplotlib(tmp_path):
    """In a process where matplotlib, mpl_toolkits and imageio cannot be
    imported, the port writes every artifact and imports none of them."""
    code = f"""
import sys
for name in ("matplotlib", "mpl_toolkits", "imageio"):
    sys.modules[name] = None
import numpy as np
from reart_tpu_torch import viz
rng = np.random.RandomState(0)
pc = rng.randn(300, 3).astype(np.float32)
part = np.repeat([0, 1, 2], 100)
out = {str(tmp_path)!r}
viz.vis_pc_seq(np.stack([pc, pc + 0.1]), name="input",
               save_path=out + "/input.gif")
viz.vis_pc_seq(np.stack([pc, pc + 0.1]), pred_part=part,
               save_path=out + "/recon.gif")
viz.vis_pc(pc, part, gt_part=part, save_path=out + "/seg.html")
viz.vis_structure(pc, part, [[1, 0], [2, 0]],
                  save_path=out + "/structure.html")
loaded = [m for m in sys.modules if sys.modules[m] is not None and
          m.split(".")[0] in ("matplotlib", "mpl_toolkits", "imageio")]
assert not loaded, loaded
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path)) == ["input.gif", "recon.gif",
                                            "seg.html", "structure.html"]
    with open(tmp_path / "seg.html") as f:
        data = json.loads(f.read().split("const DATA=")[1].split(";\n")[0])
    assert [len(s["c"]) for s in data] == [300, 300]
