"""Port parity: descriptor matching and the flow-anchor setup
(reart_tpu_torch.flow) against reart_tpu.flow on the same numpy inputs, at
the cases of tests/test_flow.py. Indices and masks must be equal; anchors,
flows and refined targets agree to rtol 1e-5 (the same formulas in float32).
The SNN ratio of a near-duplicate descriptor is the root of a cross-term
squared distance of order 1e-3 between vectors of squared norm 16, which
keeps three digits under another order of summation: rtol 3e-3, atol 1e-3,
the bars of tests/test_flow.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reart_tpu import flow as jflow
from reart_tpu.ops.interpolate import (
    blend_anchor_motion_batched as jax_blend_batched,
)
from reart_tpu.train.engine import FlowContext as JaxFlowContext
from reart_tpu_torch import flow as tflow
from reart_tpu_torch.ops.interpolate import blend_anchor_motion_batched
from reart_tpu_torch.train.engine import FAR, FlowContext

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
RATIO_TOL = dict(rtol=3e-3, atol=1e-3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _descs(seed=0, n=64, d=16, ties=False):
    rng = np.random.RandomState(seed)
    d1 = rng.randn(n, d).astype(np.float32)
    # half the rows of desc2 are perturbed copies: strong matches
    d2 = rng.randn(n, d).astype(np.float32)
    d2[: n // 2] = d1[: n // 2] + 0.01 * rng.randn(n // 2, d)
    if ties:  # rows of desc2 that appear twice: equal distances
        d2[n // 2: n // 2 + 8] = d2[:8]
        d1[40:44] = d1[40]
    return d1, d2.astype(np.float32)


def _same(got, ref, floats=()):
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        if i in floats:
            np.testing.assert_allclose(g, r, **RATIO_TOL)
        else:
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("th", [0.9, 0.99])
def test_match_snn_and_smnn_match_jax(ties, th):
    d1, d2 = _descs(ties=ties)
    ref = jflow.match_snn(jnp.asarray(d1), jnp.asarray(d2), th)
    got = tflow.match_snn(_t(d1), _t(d2), th)
    _same(got, ref, floats={0})
    ref = jflow.match_smnn(jnp.asarray(d1), jnp.asarray(d2), th)
    got = tflow.match_smnn(_t(d1), _t(d2), th)
    _same(got, ref, floats={0})
    assert int(np.asarray(ref[2]).sum()) > 8  # the case matches something


def test_identical_and_degenerate_descriptors_match_jax():
    rng = np.random.RandomState(1)
    d = rng.randn(32, 8).astype(np.float32)
    _, idx, valid = tflow.match_smnn(_t(d), _t(d), th=0.99)
    assert bool(valid.all())
    np.testing.assert_array_equal(idx.numpy(), np.arange(32))
    _same((idx, valid), jflow.match_smnn(jnp.asarray(d), jnp.asarray(d),
                                         th=0.99)[1:])
    # every row the same: both distances 0, the ratio 0 / 0 is nan, no match
    same = np.ones((6, 4), np.float32)
    ratio, idx, valid = tflow.match_snn(_t(same), _t(same))
    ref = jflow.match_snn(jnp.asarray(same), jnp.asarray(same))
    assert bool(torch.isnan(ratio).all()) and not bool(valid.any())
    _same((idx, valid), ref[1:])


def test_batched_matching_equals_per_pair_and_mutual_nn_matches_jax():
    pairs = [_descs(seed=s, ties=s == 2) for s in range(3)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    dists, j, valid = tflow.match_smnn(_t(a), _t(b))
    for p in range(3):
        ref = jflow.match_smnn(jnp.asarray(a[p]), jnp.asarray(b[p]))
        _same((dists[p], j[p], valid[p]), ref, floats={0})
    tgt, ok = tflow.find_mutual_correspondences(_t(np.array([1, 0, 2])),
                                                _t(np.array([1, 0, 0])))
    np.testing.assert_array_equal(ok.numpy(), [True, True, False])
    pcs = np.random.RandomState(3).randn(3, 64, 3).astype(np.float32)
    ref = jflow.compute_corr_masks(pcs, lambda x: x, matching="mnn")
    got = tflow.compute_corr_masks(pcs, lambda x: x, matching="mnn",
                                   device="cpu")
    _same(got, ref)
    with pytest.raises(ValueError):
        tflow.compute_corr_masks(pcs, lambda x: x, matching="nope",
                                 device="cpu")


def _chain_fixture():
    rng = np.random.RandomState(0)
    n, d = 12, 16
    base = np.zeros((n, d), np.float32)
    base[:, :n] = 10.0 * np.eye(n)
    feats = np.stack([base + 0.001 * rng.randn(n, d).astype(np.float32)
                      for _ in range(3)])
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = np.arange(n)
    j = np.tile(np.arange(n), (2, 1))
    return feats, np.stack([pts] * 3), j, np.ones((2, n), bool)


@pytest.mark.parametrize("case", ["holes", "contradicted", "short",
                                  "keep_broken"])
def test_cycle_chain_matches_match_jax(case):
    feats, pcs, j, v = _chain_fixture()
    kw = dict(close_r=0.1)
    if case == "holes":
        v[0, 5] = v[1, 6] = False
    elif case in ("contradicted", "keep_broken"):
        j[0, 7] = 8
        kw["drop_broken"] = case == "contradicted"
    else:
        feats, pcs, j, v = feats[:2], pcs[:2], j[:1], v[:1]
    ref = jflow.cycle_chain_matches(pcs, feats, j, v, **kw)
    got = tflow.cycle_chain_matches(pcs, feats, j, v, device="cpu", **kw)
    _same(got, ref)
    if case == "holes":
        assert got[1].all()


def test_gate_and_rigid_refine_match_jax():
    rng = np.random.RandomState(0)
    n = 256
    pc0 = rng.randn(n, 3).astype(np.float32)
    pcs = np.stack([pc0, pc0 + 0.01])
    tgt_idx = np.arange(n)[None].copy()
    tgt_idx[0, 7] = np.argmax(np.linalg.norm(pcs[1] - pc0[7], axis=-1))
    valid = np.ones((1, n), bool)
    got = tflow.gate_matches_by_displacement(pcs, tgt_idx, valid, k_mad=6.0)
    np.testing.assert_array_equal(
        got, jflow.gate_matches_by_displacement(pcs, tgt_idx, valid, 6.0))
    assert not got[0, 7] and got[0].sum() == n - 1

    src = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    a = 0.4
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    true = np.where(src[:, :1] > 0, src @ rot.T + [0.1, 0, 0],
                    src + [0, 0.05, 0]).astype(np.float32)
    obs = true + 0.01 * rng.randn(200, 3).astype(np.float32)
    got = tflow.refine_targets_local_rigid(src, obs, k=16)
    np.testing.assert_allclose(
        got, jflow.refine_targets_local_rigid(src, obs, k=16), **TOL)
    tiny = np.ones((3, 3), np.float32)
    assert tflow.refine_targets_local_rigid(tiny * 0, tiny) is tiny


def _moving_clouds(t=4, n=128, seed=2):
    rng = np.random.RandomState(seed)
    base = rng.randn(n, 3).astype(np.float32)
    return np.stack([base + 0.01 * i for i in range(t)])


@pytest.mark.parametrize("kw", [
    {}, {"matching": "mnn"}, {"disp_gate": 6.0}, {"rigid_refine_k": 8},
    {"chain_r": 0.05}, {"centroid": [0.1, -0.2, 0.3], "scale": 0.5},
    {"th": 0.5},
])
def test_build_flow_context_matches_jax(kw):
    """Positions as descriptors: the padded anchors and flows are equal."""
    pcs = _moving_clouds()
    jkw = dict(kw)
    if "centroid" in kw:
        jkw["centroid"] = np.asarray(kw["centroid"], np.float32)
    ref = jflow.build_flow_context(pcs, extract_fn=lambda x: x, **jkw)
    got = tflow.build_flow_context(pcs, extract_fn=lambda x: x, device="cpu",
                                   **kw)
    assert isinstance(got, FlowContext) and got.pc_ref.shape[0] == 3
    np.testing.assert_allclose(got.pc_ref.numpy(), np.asarray(ref.pc_ref),
                               **TOL)
    np.testing.assert_allclose(got.flow_ref.numpy(), np.asarray(ref.flow_ref),
                               rtol=1e-5, atol=1e-5)
    real = got.pc_ref[0, :, 0].numpy() < FAR / 2
    assert real.sum() >= 3
    if not kw:
        np.testing.assert_allclose(got.flow_ref[0].numpy()[real], 0.01,
                                   atol=1e-5)


def test_ragged_anchor_lists_pad_and_blend_as_in_jax():
    """Frame pairs with 40, 2 and 0 matches: FAR-padded to one shape in
    both packages, and the blend and its mask are equal (a pair without
    real anchors masks every point)."""
    pcs = _moving_clouds(t=4, n=64)
    valid = np.zeros((3, 64), bool)
    valid[0, :40] = True
    valid[1, [5, 9]] = True
    corr = (np.tile(np.arange(64), (3, 1)), valid)
    ref = jflow.build_flow_context(pcs, corr=corr)
    got = tflow.build_flow_context(pcs, corr=corr, device="cpu")
    assert got.pc_ref.shape == (3, 40, 3)
    np.testing.assert_array_equal(got.pc_ref.numpy(), np.asarray(ref.pc_ref))
    np.testing.assert_array_equal(got.flow_ref.numpy(),
                                  np.asarray(ref.flow_ref))
    assert (got.pc_ref[2].numpy() == FAR).all()
    assert isinstance(ref, JaxFlowContext)
    out_ref, mask_ref = jax_blend_batched(jnp.asarray(pcs[:-1]), ref.pc_ref,
                                          ref.flow_ref)
    out, mask = blend_anchor_motion_batched(_t(pcs[:-1]), got.pc_ref,
                                            got.flow_ref)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    assert not mask[2].any() and mask[0].any()
    keep = mask.numpy()
    np.testing.assert_allclose(out.numpy()[keep], np.asarray(out_ref)[keep],
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError):
        tflow.build_flow_context(pcs, device="cpu")  # no extractor, no corr
