"""Visualization artifacts (reart_tpu/viz.py): the segmentation and
kinematic-structure viewers (html) and the reconstruction gifs, written
with numpy and PIL only.

The html files are the JAX package's to the byte: the same self-contained
canvas viewer (or plotly's figures where plotly imports), the same colours
and the same rounding. The gifs are drawn here: the JAX package renders each
frame through matplotlib's 3-D scatter, and this module reproduces that
picture without matplotlib. Its parts, each read off matplotlib 3.10:

  * the camera of `Axes3D.get_proj` at matplotlib's defaults (elevation 30,
    azimuth -60, no roll, camera distance 10, perspective with focal length
    1, box aspect 4:4:3) and `proj3d`'s world, view and perspective
    transforms, then the axes' data-to-pixel transform: after
    `tight_layout(pad=0)` with the axis off, the 3-D axes fills the
    320 x 320 frame and its 2-D view limits are (-0.095, 0.09);
  * the scatter's marker, `s=2` at dpi 80: a disc of radius 0.786 px
    filled, then stroked 1.11 px wide in the same colour, each pass blended
    with the point's alpha at each pixel's share of its area (antialiased,
    centred on the projected point to 1/16 px);
  * `depthshade`: points are painted far to near, with alpha falling
    linearly from 1 at the nearest to 0.3 at the farthest.

The frames cannot equal matplotlib's to the pixel: Agg blends in 8 bits at
each step and its stroker approximates the ring, where this module blends in
float64 and samples the discs (ROADMAP §3 item 29 says what the frames are
held to).
"""

from __future__ import annotations

import functools
import json

import numpy as np

try:
    import plotly.graph_objects as go

    # functional check, not just importability: test stubs (and broken
    # installs) can register a non-working plotly in sys.modules
    HAS_PLOTLY = callable(getattr(go.Figure, "add_trace", None))
except ImportError:  # plotly is optional
    HAS_PLOTLY = False


# ---------------------------------------------------------------------------
# colours: matplotlib's `jet` over the sorted unique part ids
# ---------------------------------------------------------------------------

# matplotlib/_cm.py `_jet_data`: per channel, rows (x, y0, y1) of a
# piecewise-linear map of [0, 1]
_JET_DATA = {"red": ((0.00, 0, 0),
                     (0.35, 0, 0),
                     (0.66, 1, 1),
                     (0.89, 1, 1),
                     (1.00, 0.5, 0.5)),
             "green": ((0.000, 0, 0),
                       (0.125, 0, 0),
                       (0.375, 1, 1),
                       (0.640, 1, 1),
                       (0.910, 0, 0),
                       (1.000, 0, 0)),
             "blue": ((0.00, 0.5, 0.5),
                      (0.11, 1, 1),
                      (0.34, 1, 1),
                      (0.65, 0, 0),
                      (1.00, 0, 0))}
# entries of a named colormap's lookup table (rcParams["image.lut"])
JET_N = 256


def _lookup_table(data, n: int) -> np.ndarray:
    """matplotlib.colors._create_lookup_table at gamma 1: the map sampled at
    n points of [0, 1], y1 of the segment that starts below, y0 of the one
    that ends above."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_lut() -> np.ndarray:
    """(JET_N, 3) RGB lookup table of matplotlib's `jet`."""
    return np.stack([_lookup_table(_JET_DATA[c], JET_N)
                     for c in ("red", "green", "blue")], axis=1)


def part_colors(labels: np.ndarray) -> np.ndarray:
    """(N,) int labels -> (N, 3) float RGB via jet over unique ids: the i-th
    of n sorted ids takes the entry that
    `ScalarMappable(Normalize(0, n), "jet").to_rgba(i)` takes."""
    labels = np.asarray(labels)
    uniq = sorted(set(labels.tolist()))
    lut = jet_lut()
    out = np.empty((len(labels), 3))
    for i, u in enumerate(uniq):
        x = i / float(len(uniq)) * JET_N
        if x == JET_N:  # x == 1 maps to the last entry, not past it
            x = JET_N - 1
        out[labels == u] = lut[min(max(int(x), 0), JET_N - 1)]
    return out


# ---------------------------------------------------------------------------
# self-contained HTML point-cloud viewer (no plotly)
# ---------------------------------------------------------------------------

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body{{margin:0;background:#111;color:#eee;font:13px sans-serif}}
#c{{display:block}}#hud{{position:fixed;top:8px;left:10px}}</style></head>
<body><div id="hud">{title} — drag to orbit, wheel to zoom</div>
<canvas id="c"></canvas><script>
const DATA={data};
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let rx=-1.0,rz=0.6,zoom=1.0,dragging=false,px=0,py=0;
function resize(){{cv.width=innerWidth;cv.height=innerHeight;draw()}}
addEventListener('resize',resize);
cv.onmousedown=e=>{{dragging=true;px=e.clientX;py=e.clientY}};
addEventListener('mouseup',()=>dragging=false);
addEventListener('mousemove',e=>{{if(!dragging)return;
 rz+=(e.clientX-px)*0.008;rx+=(e.clientY-py)*0.008;px=e.clientX;py=e.clientY;draw()}});
cv.onwheel=e=>{{zoom*=e.deltaY<0?1.1:0.9;draw();e.preventDefault()}};
function draw(){{
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 const cx=cv.width/2,cy=cv.height/2,s=Math.min(cx,cy)*0.8*zoom;
 const cb=Math.cos(rz),sb=Math.sin(rz),ca=Math.cos(rx),sa=Math.sin(rx);
 for(const set of DATA){{
  const pts=set.p,cols=set.c,n=pts.length/3,proj=new Array(n);
  for(let i=0;i<n;i++){{
   const x=pts[3*i],y=pts[3*i+1],z=pts[3*i+2];
   const x1=x*cb-y*sb,y1=x*sb+y*cb;
   const y2=y1*ca-z*sa,z2=y1*sa+z*ca;
   proj[i]=[x1,y2,z2,i];
  }}
  proj.sort((a,b)=>a[1]-b[1]);
  for(const[q,d,z2,i]of proj){{
   ctx.fillStyle=cols[i];
   ctx.fillRect(cx+q*s-1.5,cy-z2*s-1.5,3,3);
  }}
 }}
}}
resize();
</script></body></html>"""


def _rgb_hex(colors: np.ndarray):
    return ["#%02x%02x%02x" % tuple((np.clip(c, 0, 1) * 255).astype(int))
            for c in colors]


def _write_canvas_html(point_sets, save_path, title):
    """point_sets: list of (pc (N,3), colors (N,3))."""
    all_pts = np.concatenate([p for p, _ in point_sets], axis=0)
    center = all_pts.mean(0)
    scale = max(1e-9, np.abs(all_pts - center).max())
    data = []
    for pc, cols in point_sets:
        norm = (np.asarray(pc, np.float64) - center) / scale
        data.append({
            "p": [round(float(v), 4) for v in norm.reshape(-1)],
            "c": _rgb_hex(cols),
        })
    html = _HTML_TEMPLATE.format(title=title, data=json.dumps(data))
    with open(save_path, "w") as f:
        f.write(html)


def vis_pc(pc, pred_part, pc_gt=None, gt_part=None, name: str = "pred",
           save_path=None):
    """Side-by-side pred/GT segmentation viewer: the GT cloud is offset
    along +x by the pred cloud's extent + 40%. Arrays (numpy) in; returns
    the (points, colours) sets, and writes them to `save_path`."""
    pc = np.asarray(pc)
    sets = [(pc, part_colors(pred_part))]
    if gt_part is not None:
        gpc = np.asarray(pc_gt).copy() if pc_gt is not None else pc.copy()
        src_scale = pc[:, 0].max() - pc[:, 0].min()
        gpc[:, 0] += max(0.0, src_scale * 1.4)
        sets.append((gpc, part_colors(gt_part)))
    if save_path is None:
        return sets
    if HAS_PLOTLY:
        fig = go.Figure()
        for (p, c), nm in zip(sets, (name, "gt")):
            fig.add_trace(go.Scatter3d(
                x=p[:, 0], y=p[:, 2], z=p[:, 1], mode="markers", name=nm,
                marker=dict(color=_rgb_hex(c), size=5)))
        fig.update_layout(showlegend=True, scene=dict(aspectmode="data"))
        fig.write_html(save_path)
    else:
        _write_canvas_html(sets, save_path, name)
    return sets


# ---------------------------------------------------------------------------
# gif frames: matplotlib's default 3-D scatter, drawn with numpy
# ---------------------------------------------------------------------------

# `_render_frame`'s figure: 4 x 4 in at dpi 80, one 3-D axes filling it
FRAME_PX = 320
DPI = 80.0
# Axes3D's defaults: view_init (elev, azim; no roll), the camera distance,
# the focal length of proj_type "persp", set_box_aspect(None) at zoom 1
ELEV, AZIM, DIST, FOCAL_LENGTH = 30.0, -60.0, 10.0, 1.0
_ASPECT = np.asarray((4, 4, 3), dtype=float)
BOX_ASPECT = _ASPECT * (1.8294640721620434 * 25 / 24
                        / np.linalg.norm(_ASPECT))
# Axes3D.set_top_view: the 2-D view limits of the projected coordinates
VIEW_LIM = (-0.95 / DIST, 0.9 / DIST)
# the scatter's marker: s=2 (points^2) is a circle of diameter sqrt(2) pt,
# stroked with the collection's default line width of 1 pt
MARKER_RADIUS = 0.5 * np.sqrt(2.0) * DPI / 72.0
STROKE_HALF_WIDTH = 0.5 * 1.0 * DPI / 72.0
# depthshade: alpha 1 - DEPTH_FADE * (normalised depth)
DEPTH_FADE = 0.7
# frame time of the gifs: the 0.3 s that the JAX package's call asks for
# (ROADMAP §3 item 28)
GIF_FRAME_MS = 300
_WHITE = 255.0
_SEQ_COLOR = (0.2, 0.4, 0.9)


def _nonsingular(v0: float, v1: float, expander: float = 0.05):
    """The limits an axis keeps (matplotlib.transforms.nonsingular through
    the axis' locator): a range of zero width is widened."""
    v0, v1 = float(v0), float(v1)
    if not (np.isfinite(v0) and np.isfinite(v1)):
        return -expander, expander
    if v1 < v0:
        v0, v1 = v1, v0
    maxabs = max(abs(v0), abs(v1))
    if maxabs < (1e6 / 1e-15) * np.finfo(float).tiny:
        return -expander, expander
    if v1 - v0 <= maxabs * 1e-15:
        if v1 == 0 and v0 == 0:
            return -expander, expander
        return v0 - expander * abs(v0), v1 + expander * abs(v1)
    return v0, v1


def projection_matrix(lims) -> np.ndarray:
    """Axes3D.get_proj at the default view: (4, 4) from the axes' data
    coordinates to the projected ones. lims: the axes' ((xmin, xmax), (ymin,
    ymax), (zmin, zmax))."""
    (x0, x1), (y0, y1), (z0, z1) = (_nonsingular(*lim) for lim in lims)
    # proj3d.world_transformation: each axis onto [0, box aspect]
    dx, dy, dz = (x1 - x0) / BOX_ASPECT[0], (y1 - y0) / BOX_ASPECT[1], \
        (z1 - z0) / BOX_ASPECT[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx],
                      [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz],
                      [0, 0, 0, 1]])
    middle = 0.5 * BOX_ASPECT
    elev, azim = np.deg2rad(ELEV), np.deg2rad(AZIM)
    ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim),
                   np.sin(elev)])
    # proj3d._view_axes with z vertical and no roll
    w = (middle + DIST * ps) - middle
    w = w / np.linalg.norm(w)
    u = np.cross(np.array([0.0, 0.0, 1.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    # proj3d._view_transformation_uvw from the focal-length-scaled eye
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -(middle + DIST * ps * FOCAL_LENGTH)
    view = np.dot(rot, shift)
    # proj3d._persp_transformation(-DIST, DIST, FOCAL_LENGTH)
    zfront, zback = -DIST, DIST
    persp = np.array([
        [FOCAL_LENGTH, 0, 0, 0],
        [0, FOCAL_LENGTH, 0, 0],
        [0, 0, (zfront + zback) / (zfront - zback),
         -2 * (zfront * zback) / (zfront - zback)],
        [0, 0, -1, 0]])
    return np.dot(persp, np.dot(view, world))


def project(points, lims):
    """The scatter's points on the frame. points (N, 3) in the axes' data
    coordinates. Returns (x, y) display pixels (y up from the bottom edge),
    the projected depth (larger is farther) and the points the projection
    keeps (proj3d._proj_transform_clip)."""
    pts = np.asarray(points, np.float64)
    vec = np.concatenate([pts.T, np.ones((1, len(pts)))])
    vecw = np.dot(projection_matrix(lims), vec)
    tx, ty, tz = vecw[0] / vecw[3], vecw[1] / vecw[3], vecw[2] / vecw[3]
    keep = (-1 <= tx) & (tx <= 1) & (-1 <= ty) & (ty <= 1) & (tz <= 0)
    # transData: the view limits onto the axes' box, the whole frame
    lo, hi = VIEW_LIM
    x = (tx - lo) / (hi - lo) * FRAME_PX
    y = (ty - lo) / (hi - lo) * FRAME_PX
    return x, y, tz, keep


# a marker's pixels: the STAMP x STAMP block whose centre pixel holds the
# marker's centre, sampled at SUBPIXEL x SUBPIXEL centre positions a pixel
STAMP = 5
SUBPIXEL = 16


@functools.lru_cache(maxsize=1)
def marker_stamps() -> tuple[np.ndarray, np.ndarray]:
    """(SUBPIXEL, SUBPIXEL, STAMP, STAMP) coverages of a marker's fill and
    of its stroke, for a centre at (row, column) offset ((i + 0.5) /
    SUBPIXEL, (j + 0.5) / SUBPIXEL) within the centre pixel: the share of
    16 x 16 samples of each pixel inside the disc, and inside the ring."""
    samples = 16
    grid = (np.arange(STAMP * samples) + 0.5) / samples - STAMP // 2
    frac = (np.arange(SUBPIXEL) + 0.5) / SUBPIXEL
    dy = grid[None, :, None] - frac[:, None, None]
    dx = grid[None, None, :] - frac[:, None, None]
    r = np.hypot(dy[:, None, :, :], dx[None, :, :, :])  # (fy, fx, y, x)

    def share(inside):
        return inside.reshape(SUBPIXEL, SUBPIXEL, STAMP, samples, STAMP,
                              samples).mean(axis=(3, 5))

    fill = share(r <= MARKER_RADIUS)
    stroke = share((r >= MARKER_RADIUS - STROKE_HALF_WIDTH)
                   & (r <= MARKER_RADIUS + STROKE_HALF_WIDTH))
    for a in (fill, stroke):
        a.setflags(write=False)
    return fill, stroke


def render_frame(pc, colors, lims) -> np.ndarray:
    """One frame of the JAX package's `_render_frame`: (320, 320, 3) uint8
    on white. pc (N, 3) is drawn with the axes mapped (x, z, y), as the
    JAX package plots it, on the axes' limits `lims` (per coordinate of
    pc, over the whole sequence)."""
    pc = np.asarray(pc, np.float64)
    colors = np.asarray(colors, np.float64)
    x, y, depth, keep = project(pc[:, [0, 2, 1]],
                                (lims[0], lims[2], lims[1]))
    idx = np.flatnonzero(keep)
    img = np.full((FRAME_PX, FRAME_PX, 3), _WHITE)
    if idx.size == 0:
        return img.astype(np.uint8)
    depth = depth[idx]
    span = depth.max() - depth.min()
    norm = (depth - depth.min()) / span if span > 0 else np.zeros_like(depth)
    alpha = 1.0 - norm * DEPTH_FADE
    # painted far to near: the rank of each point in that order
    order = np.empty(idx.size, np.int64)
    order[np.argsort(depth, kind="stable")[::-1]] = np.arange(idx.size)
    rgb = np.round(np.clip(colors[idx], 0.0, 1.0) * 255.0)
    # the marker's centre in the buffer (rows down from the top edge; pixel
    # (r, c) spans [r, r + 1] x [c, c + 1]), its pixel and sub-pixel cell
    cx, cy = x[idx], FRAME_PX - y[idx]
    col, row = np.floor(cx).astype(np.int64), np.floor(cy).astype(np.int64)
    fx = np.minimum(((cx - col) * SUBPIXEL).astype(np.int64), SUBPIXEL - 1)
    fy = np.minimum(((cy - row) * SUBPIXEL).astype(np.int64), SUBPIXEL - 1)

    fill, stroke = marker_stamps()
    half = STAMP // 2
    r = row[:, None] + (np.arange(STAMP * STAMP) // STAMP - half)[None]
    c = col[:, None] + (np.arange(STAMP * STAMP) % STAMP - half)[None]
    a = alpha[:, None]
    # the fill, then the stroke over it, each blended at the point's alpha
    cover = 1.0 - (1.0 - a * fill[fy, fx].reshape(idx.size, -1)) \
        * (1.0 - a * stroke[fy, fx].reshape(idx.size, -1))
    inside = (r >= 0) & (r < FRAME_PX) & (c >= 0) & (c < FRAME_PX) \
        & (cover > 0)
    pix = (r * FRAME_PX + c)[inside]
    cover = cover[inside]
    rank = np.broadcast_to(order[:, None], inside.shape)[inside]
    src = np.broadcast_to(np.arange(idx.size)[:, None], inside.shape)[inside]

    # composite each pixel's contributions in the painting order: a pixel
    # keeps prod(1 - cover) of its background and each contribution's
    # colour times its cover times what the later (nearer) ones let through
    seq = np.lexsort((-rank, pix))  # per pixel, nearest first
    pix, cover, src = pix[seq], cover[seq], src[seq]
    # log(1 - cover); a full cover lets 1e-22 through, far below a level
    with np.errstate(divide="ignore"):
        log_t = np.maximum(np.log1p(-cover), -50.0)
    excl = np.cumsum(log_t) - log_t
    start = np.r_[True, pix[1:] != pix[:-1]]
    seg = np.cumsum(start) - 1
    weight = np.exp(excl - excl[start][seg]) * cover
    total = np.exp(np.bincount(seg, weights=log_t))
    flat = img.reshape(-1, 3)
    first = pix[start]
    for ch in range(3):
        painted = np.bincount(seg, weights=weight * rgb[src, ch])
        flat[first, ch] = _WHITE * total + painted
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def vis_pc_seq(pc_list, pred_part=None, name: str = "seq", save_path=None):
    """Animated gif over frames: one 320 x 320 frame per cloud of pc_list
    (T, N, 3), coloured by pred_part (N,) or one blue, the limits taken
    over the whole sequence. Returns the list of frames."""
    pc_list = np.asarray(pc_list)
    colors = (part_colors(pred_part) if pred_part is not None
              else np.tile([_SEQ_COLOR], (pc_list.shape[1], 1)))
    flat = pc_list.reshape(-1, 3)
    lims = [(flat[:, i].min(), flat[:, i].max()) for i in range(3)]
    frames = [render_frame(pc, colors, lims) for pc in pc_list]
    if save_path is not None:
        from PIL import Image

        images = [Image.fromarray(f) for f in frames]
        images[0].save(save_path, format="GIF", save_all=True,
                       append_images=images[1:], loop=0,
                       duration=GIF_FRAME_MS)
    return frames


# ---------------------------------------------------------------------------
# kinematic structure
# ---------------------------------------------------------------------------

def _cylinder_grid(r, h, nt=100, nv=50):
    """Parametrized cylinder surface grid: (nv, nt, 3) with the axis along
    +z from 0 to h."""
    theta = np.linspace(0, 2 * np.pi, nt)
    v = np.linspace(0, h, nv)
    theta, v = np.meshgrid(theta, v)
    return np.stack([r * np.cos(theta), r * np.sin(theta), v], axis=2)


def _edge_cylinder(parent_centroid, child_centroid, r=0.01):
    """A z-axis cylinder of the edge's length rotated onto the
    centroid-to-centroid direction (Rodrigues from cross/dot, with the
    antipodal special case) and planted at the child centroid."""
    d = parent_centroid - child_centroid
    h = float(np.linalg.norm(d)) + 1e-6
    cy = _cylinder_grid(r, h)
    line1 = np.array([0.0, 0.0, 1.0])
    line2 = d / h
    v = np.cross(line1, line2)
    c = float(np.dot(line1, line2)) + 1e-8
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    rot = np.eye(3) + k + k @ k * (1.0 / (1.0 + c))
    if abs(c + 1.0) < 1e-4:  # cos = -1: the formula degenerates
        rot = np.array([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    t = child_centroid + 5e-3 * line2
    return cy @ rot.T + t  # (nv, nt, 3)


def vis_structure(cano_pc, seg_part, joint_connection, save_path=None):
    """Kinematic-structure viewer: part point clouds, black centroid joint
    markers and cylinder-surface edges between parent and child centroids
    (plotly Surface traces with plotly, dense point samples of the same
    grids in the canvas viewer). Returns the (points, colours) sets."""
    cano_pc = np.asarray(cano_pc)
    seg_part = np.asarray(seg_part)
    cols = part_colors(seg_part)
    uniq = sorted(set(seg_part.tolist()))
    centroids = {u: cano_pc[seg_part == u].mean(0) for u in uniq}
    cylinders = []
    for a, b in joint_connection:
        ca, cb = int(a), int(b)  # (child, parent) edges
        if ca not in centroids or cb not in centroids:
            print(f"empty edge {cb}-{ca}: a part has no points")
            continue
        cylinders.append(_edge_cylinder(centroids[cb], centroids[ca]))
    joint_pts = np.stack([centroids[u] for u in uniq])
    sets = [(cano_pc, cols),
            (joint_pts, np.zeros((len(uniq), 3)))]  # black joint markers
    if cylinders:
        cyl_pts = np.concatenate([c.reshape(-1, 3) for c in cylinders])
        sets.append((cyl_pts, np.tile([[0.85, 0.85, 0.85]],
                                      (len(cyl_pts), 1))))
    if save_path is None:
        return sets
    if HAS_PLOTLY:
        fig = go.Figure()
        for i, u in enumerate(uniq):
            cp = centroids[u][None]
            fig.add_trace(go.Scatter3d(
                x=cp[:, 0], y=cp[:, 2], z=cp[:, 1], mode="markers",
                name=f"joint_{u}", marker=dict(color="black", size=20)))
        fig.add_trace(go.Scatter3d(
            x=cano_pc[:, 0], y=cano_pc[:, 2], z=cano_pc[:, 1],
            mode="markers", name="pc",
            marker=dict(color=_rgb_hex(cols), size=5)))
        for cy in cylinders:
            fig.add_trace(go.Surface(
                x=cy[:, :, 0], y=cy[:, :, 2], z=cy[:, :, 1],
                opacity=0.5, showscale=False))
        fig.update_layout(showlegend=True, scene=dict(
            xaxis_title="x", yaxis_title="z", zaxis_title="y",
            aspectmode="data"))
        fig.write_html(save_path)
    else:
        _write_canvas_html(sets, save_path, "structure")
    return sets
