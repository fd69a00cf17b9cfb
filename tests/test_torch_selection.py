"""selection.py of the port against reart_tpu on the CPU, on the same numpy
inputs: the holdout split exactly, the interpolated holdout score (rtol
1e-5), the frozen-screw solve on the held frames (rtol 1e-4) and the whole
holdout score (rtol 1e-3) on JAX parameters carried across; the selection
energy of a fit (rtol 1e-5); and the canonical-frame sweep from the JAX
package's initial parameters and Gumbel draws (the same best frame;
energies within rtol 1e-3 without the assignment loss, within the JAX
package's own 2e-2 with it)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import selection as jsel
from reart_tpu.geometry import se3_exp_tw as jax_se3_exp_tw
from reart_tpu.models import kinematic as jk
from reart_tpu.models.base_model import init_base_params
from reart_tpu.train import FitConfig as JaxFitConfig
from reart_tpu_torch import selection
from reart_tpu_torch.data.synth import make_toy_robot_sample
from reart_tpu_torch.interop import (
    base_params_from_jax,
    kinematic_params_from_jax,
    kinematic_params_to_numpy,
)
from reart_tpu_torch.train import FitConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("t", range(1, 13))
@pytest.mark.parametrize("every", [2, 3, 5])
def test_holdout_split_matches_jax(t, every):
    got = selection.holdout_split(t, every)
    ref = jsel.holdout_split(t, every)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


T_FIT, N = 7, 60
EDGES, ROOT = [(4, 1), (1, 0), (2, 0), (3, 2)], 0


def _models(prismatic, root_trans, seed=0):
    """A 5-part tree over T_FIT frames: the JAX state, GT parameters and
    the clouds they make (plus noise), and a perturbed fit of the train
    frames, as JAX parameters."""
    rng = np.random.RandomState(seed)
    e = len(EDGES)
    axis = rng.randn(e, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    gt = dict(axis_list=axis,
              moment_list=0.3 * rng.randn(e, 3).astype(np.float32),
              theta_list=0.4 * rng.randn(T_FIT, e).astype(np.float32))
    joint_types = None
    if prismatic:
        gt["distance_list"] = 0.2 * rng.randn(T_FIT, e).astype(np.float32)
        joint_types = ["prismatic" if i % 2 else "revolute" for i in range(e)]
    if root_trans:
        rt = np.asarray(jax_se3_exp_tw(
            jnp.asarray(0.2 * rng.randn(T_FIT, 3).astype(np.float32)),
            jnp.asarray(0.1 * rng.randn(T_FIT, 3).astype(np.float32))))
        gt["root_trans"] = rt.astype(np.float32)
    cano = rng.randn(N, 3).astype(np.float32)
    seg = np.concatenate([np.arange(e + 1), rng.randint(0, e + 1, N - e - 1)])
    jstate = jk.make_kinematic_state(seg, cano, EDGES, ROOT,
                                     joint_types=joint_types,
                                     has_root_trans=root_trans)
    jgt = jk.init_kinematic_params(T_FIT, e, **gt)
    pcs = np.asarray(jk.kinematic_forward(jgt, jstate, jnp.asarray(cano))[0])
    pcs = (pcs + 0.01 * rng.randn(*pcs.shape)).astype(np.float32)
    train, _ = jsel.holdout_split(T_FIT)
    fitted = {}
    for k, v in jgt.items():
        v = np.asarray(v)
        if k in jsel._PER_FRAME_KEYS:
            v = v[train]
        fitted[k] = jnp.asarray(
            (v + 0.05 * rng.randn(*v.shape)).astype(np.float32))
    return jstate, jgt, fitted, cano, pcs


CASES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("prismatic, root_trans", CASES)
def test_holdout_score_interp_matches_jax(prismatic, root_trans):
    jstate, _, fitted, cano, pcs = _models(prismatic, root_trans)
    train, held = jsel.holdout_split(T_FIT)
    ref = jsel.holdout_score_interp(fitted, jstate, jnp.asarray(cano), pcs,
                                    train, held)
    model, state = kinematic_params_from_jax(
        jax.tree.map(np.asarray, fitted), jstate, device="cpu")
    got = selection.holdout_score_interp(model, state, torch.from_numpy(cano),
                                         pcs, train, held)
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the candidate's model is not touched
    for k, v in kinematic_params_to_numpy(model).items():
        np.testing.assert_array_equal(v, np.asarray(fitted[k]), err_msg=k)


@pytest.mark.parametrize("prismatic, root_trans", CASES)
def test_holdout_solve_matches_jax(prismatic, root_trans):
    jstate, _, fitted, cano, pcs = _models(prismatic, root_trans)
    _, held = jsel.holdout_split(T_FIT)
    ref = jsel._holdout_solve(fitted, jstate, jnp.asarray(cano),
                              jnp.asarray(pcs[held]), n_iter=60)
    model, state = kinematic_params_from_jax(
        jax.tree.map(np.asarray, fitted), jstate, device="cpu")
    got = selection._holdout_solve(model, state, torch.from_numpy(cano),
                                   torch.from_numpy(pcs[held]), n_iter=60)
    # 60 AMSGrad steps: rtol 1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    for k, v in kinematic_params_to_numpy(model).items():
        np.testing.assert_array_equal(v, np.asarray(fitted[k]), err_msg=k)


FIT = dict(n_iter=15, use_assign_loss=True, assign_iter=0, assign_gap=1,
           downsample=2)


@pytest.mark.parametrize("prismatic, root_trans", [(False, False),
                                                   (True, True)])
def test_holdout_score_matches_jax(prismatic, root_trans):
    """The whole score: a train-frame fit from the candidate's initial
    model (a LAP each iteration), the solve and the interpolation; rtol
    1e-3, the fit's parity bar (tests/test_torch_kinematic.py)."""
    jstate, jgt, _, cano, pcs = _models(prismatic, root_trans, seed=1)
    init = {k: jnp.asarray(np.asarray(v) + np.float32(0.03))
            for k, v in jgt.items()}
    ref = jsel.holdout_score(jax.random.PRNGKey(0), init, jstate,
                             JaxFitConfig(dispatch_chunk=15, **FIT),
                             jnp.asarray(cano), jnp.asarray(pcs),
                             solve_iter=40)
    model, state = kinematic_params_from_jax(
        jax.tree.map(np.asarray, init), jstate, device="cpu")
    got = selection.holdout_score(model, state, FitConfig(**FIT),
                                  torch.from_numpy(cano),
                                  torch.from_numpy(pcs), solve_iter=40)
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    for k, v in kinematic_params_to_numpy(model).items():
        np.testing.assert_array_equal(v, np.asarray(init[k]), err_msg=k)


def _perturbed(sample, seed, n_cols=5):
    """Labels and poses as a fit leaves them: GT parts over n_cols pose
    columns, some points on a wrong part, a few on a label of their own,
    every pose a little off."""
    rng = np.random.RandomState(seed)
    gt = sample["gt_cano_part"]
    cols = rng.permutation(n_cols)
    seg = cols[gt]
    wrong = rng.choice(len(seg), 25, replace=False)
    seg[wrong] = cols[rng.randint(0, 3, 25)]
    seg[rng.choice(len(seg), 5, replace=False)] = cols[3]
    t = sample["pc_list"].shape[0]
    trans = np.tile(np.eye(4, dtype=np.float32), (t, n_cols, 1, 1))
    trans[:, cols[:3]] = sample["gt_pose_list"][1:]
    noise = np.asarray(jax_se3_exp_tw(
        jnp.asarray(0.01 * rng.randn(t * n_cols, 3).astype(np.float32)),
        jnp.asarray(0.005 * rng.randn(t * n_cols, 3).astype(np.float32))))
    return seg, (noise.reshape(t, n_cols, 4, 4) @ trans).astype(np.float32)


@pytest.mark.parametrize("seed, include_group, single", [
    (0, True, False), (1, True, False), (0, False, False), (0, True, True)])
def test_fit_energy_matches_jax(seed, include_group, single):
    sample = make_toy_robot_sample()
    seg, trans = _perturbed(sample, seed)
    if single:  # one part: a rigid fit, no tree
        seg = np.full_like(seg, 2)
    cano, pcs = sample["cano_pc"], sample["pc_list"]
    ref = jsel.fit_energy(None, None, jnp.asarray(cano), jnp.asarray(pcs), 0,
                          seg, trans, None, include_group=include_group)
    got = selection.fit_energy(torch.from_numpy(cano), torch.from_numpy(pcs),
                               0, seg, torch.from_numpy(trans),
                               include_group=include_group)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-9,
                                   err_msg=k)


def _toy_complete(t=4, n=96, seed=0):
    """Two rigid boxes, the second hinging about z: the sequence of
    tests/test_parallel.py."""
    rng = np.random.RandomState(seed)
    half = n // 2
    left = rng.uniform([-1.0, -0.25, -0.25], [-0.2, 0.25, 0.25], (half, 3))
    right = rng.uniform([0.2, -0.25, -0.25], [1.0, 0.25, 0.25], (half, 3))
    cano = np.concatenate([left, right]).astype(np.float32)
    frames = [cano]
    for i in range(1, t):
        ang = 0.25 * i
        rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        moved = cano.copy()
        moved[half:] = moved[half:] @ rot.T
        frames.append(moved)
    return np.stack(frames)


@pytest.mark.parametrize("assign, rtol", [(False, 1e-3), (True, 2e-2)])
def test_select_canonical_frame_matches_jax(assign, rtol, monkeypatch):
    """Every candidate frame fitted from the JAX package's initial
    parameters and draws. Without the assignment loss the fits run the
    same arithmetic: energies within rtol 1e-3. With it the matchings may
    part ways (ROADMAP.md §3 item 12): the JAX package's own bar for two
    ways of running its sweep, rtol 2e-2 (tests/test_parallel.py).

    The JAX sweep's initial proposals are its init_base_params' with a
    seeded perturbation of the identity, as in tests/test_torch_fit.py: at
    the identity the seg MLP's exact first gradient is zero and Adam turns
    each package's rounding there into opposite steps of the learning rate
    (ROADMAP.md §3), which 40 iterations carry to 5% in the energy."""
    complete = _toy_complete()
    t, n = complete.shape[:2]
    kw = dict(n_iter=40, use_assign_loss=assign, assign_iter=20,
              assign_gap=5, downsample=2, start_tau=2.0, end_tau=1.0)
    key = jax.random.PRNGKey(0)
    init = jax.tree.map(np.asarray, init_base_params(key, 3, t - 1))
    rng = np.random.RandomState(1)
    init["proposal_6d"] = init["proposal_6d"] + (
        0.1 * rng.randn(*init["proposal_6d"].shape)).astype(np.float32)
    init["proposal_t"] = (
        0.1 * rng.randn(*init["proposal_t"].shape)).astype(np.float32)
    monkeypatch.setattr(
        "reart_tpu.models.base_model.init_base_params",
        lambda *_a, **_kw: jax.tree.map(jnp.asarray, init))
    ref_best, ref = jsel.select_canonical_frame(
        key, complete, JaxFitConfig(dispatch_chunk=10, **kw), num_parts=3,
        include_group=True, verbose=False)

    def noise(it):  # JAX's draw of iteration `it`
        return np.array(jax.random.gumbel(jax.random.fold_in(key, it),
                                          (n, 3), jnp.float32))

    best, got = selection.select_canonical_frame(
        complete, FitConfig(**kw), 3, include_group=True, verbose=False,
        init_model=lambda: base_params_from_jax(init, device="cpu"),
        noise=noise, device="cpu")
    assert best == ref_best
    assert list(got) == list(ref) == list(range(t))
    for i in ref:
        np.testing.assert_allclose(got[i]["total_err"], ref[i]["total_err"],
                                   rtol=rtol, err_msg=f"candidate {i}")


def test_command_line_auto_cano(robot_dir, tmp_path, capsys):
    """`--auto_cano` through the port's command line on the toy robot: one
    energy per frame, all finite, the printed frame the one the run's
    result.pkl holds; the run from that frame is healthy."""
    import os
    import re

    from reart_tpu_torch import checkpoint as ckpt
    from reart_tpu_torch import cli

    save_root = str(tmp_path / "exp")
    results = cli.main([
        "robot", "--device", "cpu", "--seq_path", robot_dir, "--save_root",
        save_root, "--num_points", "360", "--use_flow_loss",
        "--flow_provider", "gt", "--use_assign_loss", "--n_iter", "600",
        "--assign_iter", "400", "--num_parts", "5", "--start_tau", "2",
        "--end_tau", "0.5", "--auto_cano", "--auto_cano_iters", "40",
        "--silence"])
    out = capsys.readouterr().out
    energies = [float(e) for e in re.findall(r"cano \d+: total_err (\S+)",
                                             out)]
    assert len(energies) == 4 and np.isfinite(energies).all()
    [best] = re.findall(r"auto_cano: selected frame (\d+)", out)
    assert energies[int(best)] == min(energies)  # candidates 0..3 in order
    saved = ckpt.load_result(os.path.join(
        save_root, os.path.basename(robot_dir), "result.pkl"))
    assert saved["cano_idx"] == int(best)
    assert results["seg_ri"] > 0.9 and results["ted"] == 0.0, results
