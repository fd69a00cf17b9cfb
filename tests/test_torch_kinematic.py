"""Port parity for the projection ("kinematic") stage on the CPU: the
compiled tree, forward kinematics and its gradients, the DAG and screw
extraction between the stages (edge order included, against the JAX
package's networkx version), and a short `fit_kinematic` history, each from
the same numpy inputs in both packages. Tolerances are stated at each
comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import networkx as nx

from reart_tpu.graph.kinematics import build_graph as jax_build_graph
from reart_tpu.graph.kinematics import edge_index2edges as jax_edge_index2edges
from reart_tpu.graph.kinematics import to_dag as jax_to_dag
from reart_tpu.models import kinematic as jk
from reart_tpu.train import FitConfig as JaxFitConfig
from reart_tpu.train import FlowContext as JaxFlowContext
from reart_tpu.train import fit_kinematic as jax_fit_kinematic
from reart_tpu_torch.graph.kinematics import (
    build_graph,
    edge_index2edges,
    to_dag,
)
from reart_tpu_torch.interop import (
    kinematic_params_from_jax,
    kinematic_params_to_numpy,
)
from reart_tpu_torch.models.kinematic import (
    KinematicModel,
    compile_tree,
    fk,
    kinematic_forward,
    make_kinematic_state,
)
from reart_tpu_torch.train import FitConfig, FlowContext, fit_kinematic

torch.set_num_threads(1)

TREES = {
    "chain": ([(1, 0), (2, 1), (3, 2)], 0),
    "star": ([(0, 2), (1, 2), (3, 2)], 2),
    "mixed": ([(4, 1), (1, 0), (2, 0), (3, 2)], 0),
}


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("pad_depth", [None, 5])
def test_compile_tree_matches_jax(name, pad_depth):
    edges, root = TREES[name]
    p = len(edges) + 1
    ref = jk.compile_tree(edges, root, p, pad_depth=pad_depth)
    got = compile_tree(edges, root, p, pad_depth=pad_depth)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == ref[0].dtype and got[1] == ref[1]


def _model_inputs(name, prismatic, root_trans, seed=0, t=3, n=50):
    """Seeded screws, angles and a labelled cloud for one of TREES."""
    edges, root = TREES[name]
    e, p = len(edges), len(edges) + 1
    rng = np.random.RandomState(seed)
    axis = rng.randn(e, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    kw = dict(axis_list=axis,
              moment_list=0.3 * rng.randn(e, 3).astype(np.float32),
              theta_list=0.5 * rng.randn(t, e).astype(np.float32))
    joint_types = None
    if prismatic:
        kw["distance_list"] = 0.2 * rng.randn(t, e).astype(np.float32)
        joint_types = ["prismatic" if i % 2 else "revolute" for i in range(e)]
    if root_trans:
        rot = np.asarray(jax.vmap(lambda v: jax.scipy.linalg.expm(
            jnp.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                       [-v[1], v[0], 0]])))(
            jnp.asarray(0.3 * rng.randn(t, 3).astype(np.float32))))
        rt = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
        rt[:, :3, :3] = rot
        rt[:, :3, 3] = 0.1 * rng.randn(t, 3)
        kw["root_trans"] = rt
    cano = rng.randn(n, 3).astype(np.float32)
    seg = np.concatenate([np.arange(p), rng.randint(0, p, n - p)])
    return edges, root, kw, joint_types, cano, seg


def _both(name, prismatic=False, root_trans=False):
    edges, root, kw, joint_types, cano, seg = _model_inputs(
        name, prismatic, root_trans)
    t, e = kw["theta_list"].shape
    jstate = jk.make_kinematic_state(seg, cano, edges, root,
                                     joint_types=joint_types,
                                     has_root_trans=root_trans)
    jparams = jk.init_kinematic_params(t, e, **kw)
    tstate = make_kinematic_state(seg, cano, edges, root,
                                  joint_types=joint_types,
                                  has_root_trans=root_trans, device="cpu")
    tparams = KinematicModel(t, e, device="cpu", **kw)
    return jparams, jstate, tparams, tstate, cano


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("prismatic", [False, True])
@pytest.mark.parametrize("root_trans", [False, True])
def test_forward_matches_jax(name, prismatic, root_trans):
    jparams, jstate, tparams, tstate, cano = _both(name, prismatic,
                                                   root_trans)
    # the model built from the JAX parameters and state is the same model
    for k, v in kinematic_params_to_numpy(tparams).items():
        np.testing.assert_allclose(v, np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    tparams2, tstate2 = kinematic_params_from_jax(
        jax.tree.map(np.asarray, jparams), jstate, device="cpu")
    assert tstate2.edges == tstate.edges
    assert tstate2.reverse_topo == tstate.reverse_topo
    assert torch.equal(tstate2.path_edges, tstate.path_edges)

    ref_fk = np.asarray(jk.fk(jparams, jstate))
    for params, state in ((tparams, tstate), (tparams2, tstate2)):
        with torch.no_grad():
            got_fk = fk(params, state).numpy()
        # float32 products of at most 3 4x4 matrices: rtol 1e-5
        np.testing.assert_allclose(got_fk, ref_fk, rtol=1e-5, atol=1e-6)

    # another cloud than the canonical one: labels come by 1-NN transfer
    query = cano[::2] + 0.01
    ref = jk.kinematic_forward(jparams, jstate, jnp.asarray(query))
    with torch.no_grad():
        got = kinematic_forward(tparams, tstate, torch.from_numpy(query))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-6)
    # a theta override of one frame, as inverse kinematics passes it to a
    # revolute-only model without a root transform (the robot domain's)
    if not prismatic and not root_trans:
        theta = 0.2 * np.ones((1, len(tstate.edges)), np.float32)
        ref1 = jk.kinematic_forward(jparams, jstate, jnp.asarray(cano),
                                    theta_list=jnp.asarray(theta),
                                    seg_part=jstate.seg_part)
        with torch.no_grad():
            got1 = kinematic_forward(tparams, tstate, torch.from_numpy(cano),
                                     theta_list=torch.from_numpy(theta),
                                     seg_part=tstate.seg_part)
        assert got1[0].shape == (1, len(cano), 3)
        np.testing.assert_allclose(got1[0].numpy(), np.asarray(ref1[0]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["chain", "star"])
@pytest.mark.parametrize("wrt", ["theta_list", "axis_list", "moment_list"])
def test_gradients_match_jax(name, wrt):
    jparams, jstate, tparams, tstate, cano = _both(name)

    def loss(params):
        pc, _, _ = jk.kinematic_forward(params, jstate, jnp.asarray(cano),
                                        seg_part=jstate.seg_part)
        return jnp.sum(pc ** 2)

    ref = np.asarray(jax.grad(loss)(jparams)[wrt])
    pc, _, _ = kinematic_forward(tparams, tstate, torch.from_numpy(cano),
                                 seg_part=tstate.seg_part)
    got, = torch.autograd.grad(torch.sum(pc ** 2), getattr(tparams, wrt))
    # float32 sums over 3 x 50 points in another order: rtol 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _random_tree(rng, p):
    """A random labelled tree as a shuffled, randomly oriented edge list."""
    order = rng.permutation(p)
    edges = [(int(order[i]), int(order[rng.randint(0, i)]))
             for i in range(1, p)]
    edges = [e if rng.rand() < 0.5 else e[::-1] for e in edges]
    return [edges[i] for i in rng.permutation(len(edges))]


@pytest.mark.parametrize("seed", range(8))
def test_to_dag_keeps_the_networkx_edge_order(seed):
    rng = np.random.RandomState(seed)
    p = int(rng.randint(2, 10))
    edges = _random_tree(rng, p)
    for root in {0, p - 1, int(rng.randint(0, p))}:
        ref = list(jax_to_dag(nx.from_edgelist(edges, create_using=nx.Graph()),
                              root).edges())
        assert to_dag(edges, root) == ref


def _tree_poses(rng, p, t, still=()):
    """(T, P, 4, 4) poses: every part rotates about its own axis by an
    angle that grows with the frame; the parts in `still` only slide."""
    from reart_tpu.geometry import se3_exp_tw

    w = rng.randn(p, 3).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    v = 0.3 * rng.randn(p, 3).astype(np.float32)
    amp = rng.uniform(0.25, 0.5, p).astype(np.float32)
    for s in still:
        w[s] = 0.0
    frames = np.arange(1, t + 1, dtype=np.float32)[:, None, None]
    return np.array(se3_exp_tw(jnp.asarray(frames * (amp[:, None] * w)),
                               jnp.asarray(frames * (amp[:, None] * v))))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("revolute_only", [True, False])
def test_build_graph_matches_jax(seed, revolute_only):
    rng = np.random.RandomState(100 + seed)
    p, t = int(rng.randint(3, 7)), 4
    edges = np.asarray(_random_tree(rng, p))
    # in the typed build the two parts of the first edge slide without
    # rotating: a prismatic joint between them, revolute joints elsewhere
    still = () if revolute_only else tuple(edges[0])
    trans = _tree_poses(rng, p, t, still)
    kw = dict(revolute_only=revolute_only)
    if not revolute_only:
        kw["return_joint_type"] = True
    ref = jax_build_graph(edges, trans, **kw)
    got = build_graph(edges, trans, device="cpu", **kw)
    assert got[0] == list(ref[0].edges())          # edge order
    assert got[1] == ref[1]                        # root
    assert got[-2 if not revolute_only else -1] == \
        ref[-2 if not revolute_only else -1]       # edge_index
    assert edge_index2edges(got[-2 if not revolute_only else -1]) == \
        jax_edge_index2edges(ref[-2 if not revolute_only else -1])
    n_arrays = 3 if revolute_only else 4           # axis, moment, theta[, d]
    for i in range(2, 2 + n_arrays):
        # screws of float32 dual quaternions: rtol 1e-4, atol 1e-5
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-4, atol=1e-5, err_msg=str(i))
    if not revolute_only:
        assert got[-1] == ref[-1]                  # joint types
        assert {"prismatic", "revolute"} == set(got[-1])


def test_revolute_only_build_on_frames_without_rotation():
    """The revolute-only build asserts that no frame has |theta| < 1e-6 or
    |theta - pi| < 1e-6 (strict). dq_to_screw pins exactly those frames to
    theta = 1e-6, so in both packages a part that stands still, or one that
    makes a half turn, passes the assertion with the pinned angle."""
    trans = np.tile(np.eye(4, dtype=np.float32), (4, 3, 1, 1))
    for t in range(4):
        c, s = np.cos(0.3 * (t + 1)), np.sin(0.3 * (t + 1))
        trans[t, 2, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    trans[1, 2, :3, :3] = np.diag([-1.0, -1.0, 1.0])  # a half turn
    edges = np.array([[1, 0], [2, 0]])
    ref = jax_build_graph(edges, trans)
    got = build_graph(edges, trans, device="cpu")
    assert got[0] == list(ref[0].edges()) == [(1, 0), (2, 0)]
    theta = got[4].numpy()
    np.testing.assert_allclose(theta, np.asarray(ref[4]), rtol=1e-5)
    assert (theta[:, 0] == np.float32(1e-6)).all()
    assert theta[1, 1] == np.float32(1e-6)


N, T = 192, 4
FIT = dict(n_iter=20, assign_iter=8, assign_gap=3, downsample=2,
           use_flow_loss=True, use_assign_loss=True)


@pytest.fixture(scope="module")
def histories():
    """A 20-iteration projection fit in both packages from the same state:
    a 3-part chain whose GT joint angles are perturbed, so that the first
    gradients are far from zero."""
    rng = np.random.RandomState(3)
    cano = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    seg = np.digitize(cano[:, 0], [-0.3, 0.3])
    edges, root = [(0, 1), (2, 1)], 1
    axis = np.array([[0, 0, 1], [0, 1, 0]], np.float32)
    moment = np.array([[0.1, -0.2, 0.0], [0.2, 0.0, -0.1]], np.float32)
    theta_gt = np.array([[0.2, -0.15], [0.4, -0.3], [0.6, -0.45]],
                        np.float32)
    gt = jk.init_kinematic_params(T - 1, 2, axis_list=axis,
                                  moment_list=moment, theta_list=theta_gt)
    jstate = jk.make_kinematic_state(seg, cano, edges, root)
    pcs = np.asarray(jk.kinematic_forward(gt, jstate, jnp.asarray(cano),
                                          seg_part=jstate.seg_part)[0])
    complete = np.concatenate([cano[None], pcs], 0)
    anchors = [complete[i] for i in range(T - 1)]
    flows = [complete[i + 1] - complete[i] for i in range(T - 1)]

    start = dict(axis_list=axis + 0.05 * rng.randn(2, 3).astype(np.float32),
                 moment_list=moment + 0.05 * rng.randn(2, 3).astype(
                     np.float32),
                 theta_list=theta_gt + 0.1 * rng.randn(T - 1, 2).astype(
                     np.float32))
    jparams = jk.init_kinematic_params(T - 1, 2, **start)
    _, jax_hist = jax_fit_kinematic(
        jax.random.PRNGKey(0), jparams, jstate,
        JaxFitConfig(dispatch_chunk=FIT["n_iter"], **FIT), pcs,
        flow_ctx=JaxFlowContext.from_lists(anchors, flows))
    tparams, tstate = kinematic_params_from_jax(
        jax.tree.map(np.asarray, jparams), jstate, device="cpu")
    _, hist = fit_kinematic(tparams, tstate, FitConfig(**FIT), pcs,
                            flow_ctx=FlowContext.from_lists(anchors, flows),
                            device="cpu")
    return ({k: np.asarray(v) for k, v in jax_hist.items()},
            {k: v.numpy() for k, v in hist.items()})


@pytest.mark.parametrize("name", ["total_loss", "recon_loss", "ass_loss",
                                  "flow_loss"])
def test_fit_kinematic_history_matches_jax(histories, name):
    ref, got = histories[0][name], histories[1][name]
    assert got.shape == ref.shape == (FIT["n_iter"],)
    # rtol 1e-3: 20 Adam steps amplify 1-ulp differences between XLA:CPU
    # and ATen reductions
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-7)
