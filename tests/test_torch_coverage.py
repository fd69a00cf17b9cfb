"""The port covers the JAX package: every public top-level function or
class of `reart_tpu/` has a same-named definition in the same-path module
of `reart_tpu_torch/`, or an entry of COUNTERPARTS naming what stands in
for it there (which must exist), or an entry of NOT_PORTED citing the
ROADMAP item that records why not. A public name added to `reart_tpu/`
without one of these fails its module's case. Both packages are read with
`ast`; nothing is imported."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "reart_tpu")
PORT_ROOT = os.path.join(REPO, "reart_tpu_torch")

# "<jax module>.<name>": "<port module>:<name or Class.method>"
COUNTERPARTS = {
    # the init_* / apply_* pairs of parameter trees are nn.Modules
    "models.base_model.init_base_params": "models.base_model:BaseModel",
    # BaseModel.seg, the segmentation MLP
    "models.base_model.base_seg_logits": "models.blocks:MLP.forward",
    "models.blocks.init_mlp": "models.blocks:MLP",
    "models.blocks.apply_mlp": "models.blocks:mlp_apply",
    "models.kinematic.init_kinematic_params":
        "models.kinematic:KinematicModel",
    "models.pointnet2.init_pointnet2msg2": "models.pointnet2:PointNet2Msg2",
    "models.pointnet2.apply_pointnet2msg2":
        "models.pointnet2:PointNet2Msg2.forward",
    "native.get_lib": "native:load_library",
    # the Pallas kernels are CUDA kernels behind wrappers that dispatch by
    # the tensor's device (ops/pallas_* -> ops/cuda_*)
    "ops.pallas_nn.nn_topk_pallas": "ops.cuda_nn:nn_topk",
    "ops.pallas_nn.nn_topk": "ops.cuda_nn:nn_topk",
    "ops.pallas_nn.ball_query_pallas": "ops.cuda_nn:ball_query",
    "ops.pallas_nn.nn_bidir_pallas": "ops.cuda_nn:nn_bidir",
    "ops.pallas_nn.nn_bidir": "ops.cuda_nn:nn_bidir",
    "ops.pallas_nn.nn1_coords_pallas": "ops.cuda_nn:nn1_coords",
    "ops.pallas_nn.nn1_bidir_coords_pallas": "ops.cuda_nn:nn1_bidir_coords",
    "ops.pallas_nn.blend3_pallas": "ops.cuda_nn:blend3",
    "ops.pallas_auction.row_top2_pallas": "ops.cuda_auction:row_top2",
    "ops.pallas_auction.col_winner_max_pallas":
        "ops.cuda_auction:col_winner_max",
    "ops.pallas_auction.auction_solve_resident":
        "ops.cuda_auction:auction_solve_resident",
    "ops.pallas_auction.resident_available":
        "ops.cuda_auction:resident_available",
    "ops.pallas_auction.auction_solve_resident_hbm":
        "ops.cuda_auction:auction_solve_resident_hbm",
    "ops.pallas_auction.resident_hbm_available":
        "ops.cuda_auction:resident_hbm_available",
    "ops.pallas_auction.band_tile": "ops.cuda_auction:band_tile",
    "ops.pallas_auction.auction_solve_banded":
        "ops.cuda_auction:auction_solve_banded",
    "ops.pallas_auction.banded_available": "ops.cuda_auction:banded_available",
    "ops.pallas_fps.fps_pallas": "ops.cuda_fps:fps",
    "ops.sampling.fps_pallas_dispatch": "ops.cuda_fps:fps",
    # parallel/mesh as rows fits on one card
    "parallel.mesh.init_batched_params": "parallel.rows:init_batched_params",
    "parallel.mesh.make_batched_fit_step":
        "parallel.rows:make_batched_fit_step",
    "parallel.mesh.fit_base_sequences": "parallel.rows:fit_base_sequences",
    "parallel.mesh.fit_base_candidates": "parallel.rows:fit_base_candidates",
    "parallel.mesh.fit_batch": "parallel.rows:fit_batch",
    # the jitted phase programs are the fit's own step
    "train.engine.make_fit_fns": "train.engine:fit",
}

# "<jax module>.<name>": the ROADMAP item that records why it is not
# ported; every `backticked` word of the reason appears in ROADMAP.md
_HOSTOPS = "ROADMAP §1 'Do not port': `hostops.py`"
_MESH = ("ROADMAP §1 'Do not port': the mesh plumbing, `make_mesh`, "
         "`batch_spec`, `replicated_spec`")
_GATES = ("ROADMAP §3 item 30: the Pallas dispatch gates `use_pallas`, "
          "`sweep_kernels_available`, `fps_kernel_available`, "
          "`ball_query_kernel_available`")
NOT_PORTED = {
    "checkpoint.save_orbax": "ROADMAP §1 'Do not port': `save_orbax`",
    "checkpoint.load_orbax": "ROADMAP §1 'Do not port': `load_orbax`",
    "hostops.on_host": _HOSTOPS,
    "hostops.on_device": _HOSTOPS,
    "hostops.to_accel": _HOSTOPS,
    "hostops.to_host": _HOSTOPS,
    "ops.pallas_nn.use_pallas": _GATES,
    "ops.pallas_nn.ball_query_kernel_available": _GATES,
    "ops.pallas_auction.sweep_kernels_available": _GATES,
    "ops.pallas_fps.fps_kernel_available": _GATES,
    "ops.pallas_auction.band_group":
        "ROADMAP §3 item 16: the TPU kernel's `group` packing",
    "ops.sampling.index_points_mm":
        "ROADMAP §1 'Do not port': `index_points_mm`",
    "parallel.mesh.make_mesh": _MESH,
    "parallel.mesh.batch_spec": _MESH,
    "parallel.mesh.replicated_spec": _MESH,
    "train.engine.run_chunks_pipelined":
        "ROADMAP §1 'Do not port': `run_chunks_pipelined`",
}


def _module_names(root):
    """Dotted module names under root ("" for the package itself)."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append(".".join(parts))
    return sorted(out)


def _path(root, module):
    base = os.path.join(root, *module.split(".")) if module else root
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(path):
            return path
    return None


def _tree(root, module):
    path = _path(root, module)
    if path is None:
        return None
    with open(path) as f:
        return ast.parse(f.read(), path)


def _defined(tree):
    """Top-level names a module binds: def, class, assignment, and the
    names it imports from elsewhere in the package (re-exports)."""
    names = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("reart_tpu_torch"):
            for alias in node.names:
                names[alias.asname or alias.name] = node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names[t.id] = node
    return names


def _public(tree):
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _counterpart_exists(target):
    module, _, qual = target.partition(":")
    tree = _tree(PORT_ROOT, module)
    if tree is None:
        return False
    name, _, method = qual.partition(".")
    node = _defined(tree).get(name)
    if node is None:
        return False
    if not method:
        return True
    return isinstance(node, ast.ClassDef) and any(
        isinstance(n, ast.FunctionDef) and n.name == method
        for n in node.body)


def _roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        return f.read()


def _reason_problems(reason, roadmap):
    m = re.match(r"ROADMAP §(1|3 item (\d+))\b", reason)
    if m is None:
        return ["cites no ROADMAP §1 or §3 item"]
    problems = []
    if m.group(2) and not re.search(rf"^{m.group(2)}\. \*\*", roadmap,
                                    re.M):
        problems.append(f"ROADMAP.md has no §3 item {m.group(2)}")
    if m.group(1) == "1" and "Do not port the following" not in roadmap:
        problems.append("ROADMAP.md has no 'Do not port' list")
    words = re.findall(r"`([^`]+)`", reason)
    if not words:
        problems.append("names nothing in `backticks`")
    problems += [f"`{w}` is not in ROADMAP.md" for w in words
                 if f"`{w}`" not in roadmap and w not in roadmap]
    return problems


JAX_MODULES = _module_names(JAX_ROOT)


@pytest.mark.parametrize("module", JAX_MODULES,
                         ids=[m or "reart_tpu" for m in JAX_MODULES])
def test_every_public_name_is_covered(module):
    jax_tree = _tree(JAX_ROOT, module)
    port_tree = _tree(PORT_ROOT, module)
    port_names = _defined(port_tree) if port_tree is not None else {}
    roadmap = _roadmap()
    public = _public(jax_tree)
    missing, wrong = [], []
    for name in public:
        key = f"{module}.{name}" if module else name
        if key in COUNTERPARTS:
            if not _counterpart_exists(COUNTERPARTS[key]):
                wrong.append(f"{key}: counterpart {COUNTERPARTS[key]} "
                             "not found")
        elif key in NOT_PORTED:
            wrong += [f"{key}: {p}" for p in
                      _reason_problems(NOT_PORTED[key], roadmap)]
        elif name not in port_names:
            missing.append(key)
    assert not missing, ("public names of reart_tpu without a counterpart "
                         f"in reart_tpu_torch or an entry here: {missing}")
    assert not wrong, wrong
    # no stale entries: each one names a public definition of this module
    prefix = f"{module}." if module else ""
    entries = [k for k in (*COUNTERPARTS, *NOT_PORTED)
               if k.startswith(prefix)
               and "." not in k[len(prefix):]]
    assert sorted(set(entries) - {prefix + n for n in public}) == []


def test_every_entry_names_a_module_of_the_jax_package():
    keys = [*COUNTERPARTS, *NOT_PORTED]
    assert not set(COUNTERPARTS) & set(NOT_PORTED)
    assert all(k.rpartition(".")[0] in JAX_MODULES for k in keys), [
        k for k in keys if k.rpartition(".")[0] not in JAX_MODULES]
