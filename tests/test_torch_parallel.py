"""parallel/ of the port (batched fits on one card) against reart_tpu on
the CPU, on the same numpy inputs.

The rows fits against the JAX package's `fit_base_sequences` and
`fit_base_candidates` on a one-device mesh, from the JAX initial
parameters (a seeded perturbation of the identity start, ROADMAP.md §3
item 23) and the JAX draws: labels equal, transforms within TRANS_TOL.
The rows against the port's own sequential `fit_base` of each row: equal
bit for bit on the CPU. Permuting the rows permutes the outputs, bit for
bit. `fit_batch`'s per-row losses against the JAX function (rtol 1e-5 for
one step, 1e-3 for five); `_stack_flow_contexts` exactly; the batched
canonical-frame sweep against the sequential one (the same frame,
energies within the JAX package's own 2e-2); `candidates` against the
JAX sweep; `--batch_seq 0,1` through the command line.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu import parallel as jpar
from reart_tpu import selection as jsel
from reart_tpu.models.base_model import init_base_params
from reart_tpu.train import FitConfig as JaxFitConfig
from reart_tpu.train import FlowContext as JaxFlowContext
from reart_tpu_torch import parallel, selection
from reart_tpu_torch.interop import base_params_from_jax
from reart_tpu_torch.models.base_model import base_forward
from reart_tpu_torch.train import FitConfig, FlowContext, fit_base

torch.set_num_threads(1)

# labels equal; transforms to this bar. The toy's fits (a LAP every 5
# iterations) part by at most 2.4e-6 from the JAX package's; a LAP can part
# ways under an ulp (ROADMAP.md §3 item 12), so the bar is 40 times that
TRANS_TOL = dict(rtol=1e-4, atol=1e-4)
T, N, P = 4, 96, 3
KW = dict(n_iter=30, use_assign_loss=True, assign_iter=15, assign_gap=5,
          downsample=2, start_tau=2.0, end_tau=1.0)
KEY = jax.random.PRNGKey(0)


def _complete(seed=0, rate=0.25):
    """Two rigid boxes, the second hinging about z: tests/test_parallel.py's
    sequence, with the hinge rate and the points' seed free."""
    rng = np.random.RandomState(seed)
    half = N // 2
    left = rng.uniform([-1.0, -0.25, -0.25], [-0.2, 0.25, 0.25], (half, 3))
    right = rng.uniform([0.2, -0.25, -0.25], [1.0, 0.25, 0.25], (half, 3))
    cano = np.concatenate([left, right]).astype(np.float32)
    frames = [cano]
    for i in range(1, T):
        ang = rate * i
        rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        moved = cano.copy()
        moved[half:] = moved[half:] @ rot.T
        frames.append(moved)
    return np.stack(frames)


def _init():
    """The JAX initial parameters, proposals perturbed off the identity."""
    init = jax.tree.map(np.asarray, init_base_params(KEY, P, T - 1))
    rng = np.random.RandomState(1)
    init["proposal_6d"] = init["proposal_6d"] + (
        0.1 * rng.randn(*init["proposal_6d"].shape)).astype(np.float32)
    init["proposal_t"] = (
        0.1 * rng.randn(*init["proposal_t"].shape)).astype(np.float32)
    return init


def _noise(it):  # the JAX fit's draw of iteration `it`
    return np.array(jax.random.gumbel(jax.random.fold_in(KEY, it), (N, P),
                                      jnp.float32))


def _port_init(init):
    return lambda: base_params_from_jax(init, device="cpu")


def _sequences():
    """Three different sequences at canonical frame 1, with flow anchors
    of different counts (padded to one M)."""
    seqs = [_complete(seed=k, rate=0.2 + 0.08 * k) for k in range(3)]
    cano_b = np.stack([s[1] for s in seqs])
    pc_b = np.stack([np.concatenate([s[:1], s[2:]]) for s in seqs])
    ctxs = [FlowContext.from_lists([s[i][: 80 - 10 * k] for i in range(T - 1)],
                                   [(s[i + 1] - s[i])[: 80 - 10 * k]
                                    for i in range(T - 1)])
            for k, s in enumerate(seqs)]
    return seqs, cano_b, pc_b, ctxs


def _stack(ctxs):
    from reart_tpu_torch.cli import _stack_flow_contexts

    return _stack_flow_contexts(ctxs)


@pytest.fixture(scope="module")
def jax_sequences():
    """The JAX package's rows fit of _sequences with flow, on one device."""
    init = _init()
    _, cano_b, pc_b, ctxs = _sequences()
    flow = _stack(ctxs)
    cfg = JaxFitConfig(dispatch_chunk=10, use_flow_loss=True, cano_idx=1,
                       **KW)
    mp = pytest.MonkeyPatch()
    mp.setattr("reart_tpu.models.base_model.init_base_params",
               lambda *_a, **_kw: jax.tree.map(jnp.asarray, init))
    try:
        fits = jpar.fit_base_sequences(
            KEY, cfg, cano_b, pc_b, 1, P, mesh=jpar.make_mesh(1),
            flow_b=JaxFlowContext(jnp.asarray(flow.pc_ref.numpy()),
                                  jnp.asarray(flow.flow_ref.numpy())))
    finally:
        mp.undo()
    return init, fits


def test_fit_base_sequences_matches_jax(jax_sequences):
    init, ref = jax_sequences
    _, cano_b, pc_b, ctxs = _sequences()
    cfg = FitConfig(use_flow_loss=True, cano_idx=1, **KW)
    got = parallel.fit_base_sequences(
        cfg, cano_b, pc_b, 1, P, flow_b=_stack(ctxs),
        init_model=_port_init(init), noise=_noise, device="cpu")
    assert len(got) == len(ref) == 3
    for i, ((_, seg, trans), (_, jseg, jtrans)) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg),
                                      err_msg=f"row {i}")
        np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans),
                                   err_msg=f"row {i}", **TRANS_TOL)


@pytest.fixture(scope="module")
def jax_candidates():
    init = _init()
    cfg = JaxFitConfig(dispatch_chunk=10, **KW)
    mp = pytest.MonkeyPatch()
    mp.setattr("reart_tpu.models.base_model.init_base_params",
               lambda *_a, **_kw: jax.tree.map(jnp.asarray, init))
    try:
        fits = jpar.fit_base_candidates(KEY, cfg, _complete(), P, [2, 0, 2],
                                        mesh=jpar.make_mesh(1))
    finally:
        mp.undo()
    return init, fits


def test_fit_base_candidates_matches_jax(jax_candidates):
    init, ref = jax_candidates
    got = parallel.fit_base_candidates(
        FitConfig(**KW), _complete(), P, [2, 0, 2],
        init_model=_port_init(init), noise=_noise, device="cpu")
    assert sorted(got) == sorted(ref) == [0, 2]
    for idx in ref:
        _, seg, trans = got[idx]
        np.testing.assert_array_equal(seg.numpy(), np.asarray(ref[idx][1]),
                                      err_msg=f"candidate {idx}")
        np.testing.assert_allclose(trans.numpy(), np.asarray(ref[idx][2]),
                                   err_msg=f"candidate {idx}", **TRANS_TOL)


def _sequential(cfg, cano, pcs, init, flow=None):
    model, hist = fit_base(_port_init(init)(), cfg, cano, pcs,
                           flow_ctx=flow, noise=_noise, device="cpu")
    with torch.no_grad():
        _, seg, trans = base_forward(model, torch.from_numpy(cano),
                                     torch.zeros(N, P), 1.0)
    return model, seg, trans


@pytest.mark.parametrize("flow, assign", [(False, False), (False, True),
                                          (True, True)])
def test_rows_equal_sequential_fits(flow, assign):
    """Row i of the rows fit is the port's own sequential fit of row i,
    parameters, labels and transforms bit for bit on the CPU."""
    init = _init()
    seqs, cano_b, pc_b, ctxs = _sequences()
    cfg = FitConfig(**{**KW, "use_assign_loss": assign},
                    use_flow_loss=flow, cano_idx=1)
    got = parallel.fit_base_sequences(
        cfg, cano_b, pc_b, 1, P, flow_b=_stack(ctxs) if flow else None,
        init_model=_port_init(init), noise=_noise, device="cpu")
    for i in range(3):
        model, seg, trans = _sequential(
            cfg, cano_b[i], pc_b[i], init,
            FlowContext(*(x[i] for x in _stack(ctxs))) if flow else None)
        assert torch.equal(seg, got[i][1]) and torch.equal(trans, got[i][2])
        for (k, v), w in zip(model.state_dict().items(),
                             got[i][0].state_dict().values()):
            assert torch.equal(v, w), (i, k)


def test_candidate_rows_equal_sequential_fits():
    """Rows at different canonical frames (each completed at its own
    cano_idx) against the sequential fits, with flow, bit for bit."""
    from reart_tpu_torch.parallel.rows import _fit_base_rows

    init, complete, cands = _init(), _complete(), [0, 2, 3]
    flow = FlowContext.from_lists([complete[i] for i in range(T - 1)],
                                  [complete[i + 1] - complete[i]
                                   for i in range(T - 1)])
    cano_b = np.stack([complete[i] for i in cands])
    pc_b = np.stack([np.concatenate([complete[:i], complete[i + 1:]])
                     for i in cands])
    flow_b = FlowContext(flow.pc_ref[None].repeat(3, 1, 1, 1),
                         flow.flow_ref[None].repeat(3, 1, 1, 1))
    cfg = FitConfig(use_flow_loss=True, **KW)
    _, seg_b, trans_b = _fit_base_rows(
        cfg, cano_b, pc_b, cands, P, flow_b=flow_b,
        init_model=_port_init(init), noise=_noise, device="cpu")
    for r, i in enumerate(cands):
        _, seg, trans = _sequential(dataclasses.replace(cfg, cano_idx=i),
                                    cano_b[r], pc_b[r], init, flow)
        assert torch.equal(seg, seg_b[r]) and torch.equal(trans, trans_b[r])


def test_permuting_rows_permutes_outputs():
    """The row-mixing check: the same sequences in another row order give
    the same fits in that order, bit for bit."""
    init = _init()
    _, cano_b, pc_b, ctxs = _sequences()
    cfg = FitConfig(use_flow_loss=True, cano_idx=1, **KW)
    order = [2, 0, 1]

    def run(rows):
        return parallel.fit_base_sequences(
            cfg, cano_b[rows], pc_b[rows], 1, P,
            flow_b=_stack([ctxs[i] for i in rows]),
            init_model=_port_init(init), noise=_noise, device="cpu")

    base, perm = run([0, 1, 2]), run(order)
    for r, i in enumerate(order):
        assert torch.equal(perm[r][1], base[i][1])
        assert torch.equal(perm[r][2], base[i][2])
    # the sequences differ, so a mixed row would show
    assert not torch.equal(base[0][2], base[1][2])


def test_duplicate_candidates_come_back_once():
    calls = []
    fits = parallel.fit_base_candidates(
        FitConfig(n_iter=3, start_tau=2.0), _complete(), P, [1, 1, 3, 1],
        noise=lambda it: calls.append(it) or _noise(it), device="cpu")
    assert list(fits) == [1, 3]
    assert calls == [0, 1, 2]  # one draw an iteration for all rows
    for model, seg, trans in fits.values():
        assert seg.shape == (N,) and trans.shape == (T - 1, P, 4, 4)
        assert model.num_parts == P


def test_rows_forward_is_base_forward_per_row():
    models = [base_params_from_jax(_init(), device="cpu")]
    models.append(parallel.init_batched_params(
        1, P, T - 1, generator=torch.Generator().manual_seed(3),
        device="cpu").row(0))
    rows = parallel.BaseRows(models)
    cano = torch.from_numpy(np.stack([_complete(0)[0], _complete(1)[2]]))
    noise = torch.from_numpy(np.stack([_noise(0), _noise(1)]))
    got = parallel.rows_forward(rows, cano, noise, 1.5)
    for i, m in enumerate(models):
        ref = base_forward(m, cano[i], noise[i], 1.5)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g[i], r, rtol=1e-6, atol=1e-6)
        for (k, v), w in zip(m.state_dict().items(),
                             rows.row(i).state_dict().values()):
            assert torch.equal(v, w), k


def test_rows_fit_refuses_checkpoints_and_snapshots(tmp_path):
    from reart_tpu_torch.train.engine import fit

    rows = parallel.init_batched_params(2, P, T - 1, device="cpu")
    cano = torch.from_numpy(np.stack([_complete()[0]] * 2))
    pcs = torch.from_numpy(np.stack([_complete()[1:]] * 2))
    for kw in ({"checkpoint_dir": str(tmp_path)},
               {"snapshot_cb": lambda *_: None}):
        with pytest.raises(ValueError, match="rows fit"):
            fit(parallel.rows_forward, rows, FitConfig(n_iter=2), cano, pcs,
                _noise, two_group_opt=True, **kw)


@pytest.fixture(scope="module")
def batch_problem():
    key = jax.random.PRNGKey(0)
    b, t, n, p = 3, 3, 64, 3
    params = jpar.init_batched_params(key, batch=b, num_parts=p, pose_len=t)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(2)
    params["proposal_6d"] = params["proposal_6d"] + (
        0.1 * rng.randn(*params["proposal_6d"].shape)).astype(np.float32)
    cano = np.array(jax.random.normal(key, (b, n, 3), jnp.float32))
    pcs = cano[:, None] + 0.05 * np.array(jax.random.normal(
        jax.random.PRNGKey(1), (b, t, n, 3), jnp.float32))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (n, p), jnp.float32))
                      for k in jax.random.split(key, b)])
    return params, cano, pcs.astype(np.float32), noise


@pytest.mark.parametrize("n_iter, use_assign, rtol", [
    (1, False, 1e-5), (1, True, 1e-5), (5, False, 1e-3), (5, True, 1e-3)])
def test_fit_batch_matches_jax(batch_problem, n_iter, use_assign, rtol):
    """Per-row losses of the last step: one step from the same parameters
    to rtol 1e-5 (the JAX package's bar for two mesh layouts), five to
    1e-3."""
    params, cano, pcs, noise = batch_problem
    _, ref = jpar.fit_batch(jax.random.PRNGKey(0),
                            jax.tree.map(jnp.asarray, params), cano, pcs,
                            n_iter=n_iter, mesh=jpar.make_mesh(1),
                            use_assign=use_assign)
    rows = parallel.BaseRows([
        base_params_from_jax(jax.tree.map(lambda x, r=r: x[r], params),
                             device="cpu") for r in range(cano.shape[0])])
    fitted, got = parallel.fit_batch(rows, cano, pcs, n_iter,
                                     use_assign=use_assign, noise=noise,
                                     device="cpu")
    assert got.shape == (cano.shape[0],) and fitted is rows
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol)


def test_stack_flow_contexts_matches_jax():
    from reart_tpu.cli import _stack_flow_contexts as jax_stack
    from reart_tpu.train import FlowContext as JFC

    _, _, _, ctxs = _sequences()
    got = _stack(ctxs)
    ref = jax_stack([JFC(jnp.asarray(c.pc_ref.numpy()),
                         jnp.asarray(c.flow_ref.numpy())) for c in ctxs])
    np.testing.assert_array_equal(got.pc_ref.numpy(), np.asarray(ref.pc_ref))
    np.testing.assert_array_equal(got.flow_ref.numpy(),
                                  np.asarray(ref.flow_ref))
    assert _stack(ctxs[:1] + [None]) is None


def test_select_canonical_frame_batched_matches_sequential():
    complete = _complete()
    cfg = FitConfig(**KW)
    init = _init()
    runs = [selection.select_canonical_frame(
        complete, cfg, P, verbose=False, init_model=_port_init(init),
        noise=_noise, batched=batched, device="cpu")
        for batched in (False, True)]
    (best, seq), (best_b, bat) = runs
    assert best_b == best and list(bat) == list(seq) == list(range(T))
    for i in seq:
        np.testing.assert_allclose(bat[i]["total_err"], seq[i]["total_err"],
                                   rtol=2e-2, err_msg=f"candidate {i}")


def test_select_canonical_frame_candidates_matches_jax(monkeypatch):
    """`candidates=[0, 2]` against the JAX sweep: the same best frame, the
    two energies within the JAX package's own 2e-2."""
    complete = _complete()
    init = _init()
    monkeypatch.setattr(
        "reart_tpu.models.base_model.init_base_params",
        lambda *_a, **_kw: jax.tree.map(jnp.asarray, init))
    ref_best, ref = jsel.select_canonical_frame(
        KEY, complete, JaxFitConfig(dispatch_chunk=10, **KW), num_parts=P,
        candidates=[0, 2], include_group=True, verbose=False)
    best, got = selection.select_canonical_frame(
        complete, FitConfig(**KW), P, candidates=[0, 2], verbose=False,
        init_model=_port_init(init), noise=_noise, device="cpu")
    assert best == ref_best and list(got) == list(ref) == [0, 2]
    for i in ref:
        np.testing.assert_allclose(got[i]["total_err"], ref[i]["total_err"],
                                   rtol=2e-2, err_msg=f"candidate {i}")


def _rotz4(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


@pytest.fixture(scope="module")
def sapien_dir2(tmp_path_factory):
    """Two 2-part sequences (different hinge rates) for the batch sweep:
    the pattern of tests/test_cli_sapien_real.py's fixture."""
    root = tmp_path_factory.mktemp("sapien2")
    (root / "data").mkdir()
    rng = np.random.RandomState(1)
    n_per = 100
    for seq, rate in enumerate((0.3, 0.45)):
        body = rng.uniform([-0.5, -0.5, -0.2], [0.5, 0.5, 0.2], (n_per, 3))
        lid = rng.uniform([-0.5, 0.3, 0.2], [0.5, 0.5, 0.4], (n_per, 3))
        cano = np.concatenate([body, lid]).astype(np.float32)
        segm1 = np.repeat([1, 2], n_per)
        pcs, segms = [], []
        trans = {"cam": [], 1: [], 2: []}
        homo = np.concatenate([cano, np.ones((len(cano), 1))], 1)
        for v in range(3):
            cam = _rotz4(0.05 * v)
            m_lid = _rotz4(rate * v)
            trans["cam"].append(cam)
            trans[1].append(np.eye(4))
            trans[2].append(m_lid)
            world = homo.copy()
            world[n_per:] = homo[n_per:] @ m_lid.T
            pcs.append((world @ np.linalg.inv(cam).T)[:, :3].astype(
                np.float32))
            segms.append(segm1)
        np.savez(root / "data" / f"{seq:06d}.npz", pc=np.stack(pcs),
                 segm=np.stack(segms), trans=np.asarray(trans, dtype=object))
        flow = np.diff(np.stack(pcs), axis=0).astype(np.float32)
        np.savez(root / f"flow_{seq}.npz", flow=flow,
                 conf=np.ones(flow.shape[:2], np.float32))
    with open(root / "meta.json", "w") as f:
        json.dump({"test": [0, 1]}, f)
    return str(root)


def test_command_line_batch_seq(sapien_dir2, tmp_path, capsys):
    """`sapien --batch_seq 0,1` on the CPU: one rows fit, then each
    sequence's result files with the multi-scan RI, each from its own flow
    file."""
    from reart_tpu_torch import checkpoint, cli

    save_root = str(tmp_path / "exp")
    results = cli.main([
        "sapien", "--device", "cpu", "--sapien_base_folder", sapien_dir2,
        "--batch_seq", "0,1", "--save_root", save_root, "--n_iter", "150",
        "--assign_iter", "100", "--use_assign_loss", "--use_flow_loss",
        "--flow_file", os.path.join(sapien_dir2, "flow_{idx}.npz"),
        "--num_parts", "4", "--downsample", "2", "--end_tau", "0.5"])
    out = capsys.readouterr().out
    assert "batch_seq: fitting 2 sequences as one batch" in out
    assert "[phase] finalize/0" in out and "[phase] finalize/1" in out
    assert len(results) == 2
    for i, res in enumerate(results):
        txt = open(os.path.join(save_root, str(i), "result.txt")).read()
        assert "multi_scan_ri" in txt and np.isfinite(res["multi_scan_ri"])
        saved = checkpoint.load_result(os.path.join(save_root, str(i),
                                                    "result.pkl"))
        assert saved["pred_cano_part"].shape == (200,)
    with pytest.raises(ValueError, match="batch_seq"):
        cli.main(["sapien", "--device", "cpu", "--sapien_base_folder",
                  sapien_dir2, "--batch_seq", "0,1", "--evaluate"])
