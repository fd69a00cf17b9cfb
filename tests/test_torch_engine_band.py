"""The fit engine's banded LAP route on the CPU: the port's counterparts of
tests/test_engine.py::TestBandGuard, with the banded route forced on at toy
scale by monkeypatching (on the CPU every size goes dense otherwise), the
banded solve then running its plain version. The guard falls back to the
dense solver on unaligned clouds and keeps the band on aligned ones; a
re-probe flips the decision mid-fit; the decision survives a resume through
fit_state.pkl. The guard probe's two matched costs equal the JAX probe's on
one toy problem within rtol 1e-5 (float32 sums of 512 distances)."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.train import engine as jax_engine
from reart_tpu_torch.models import BaseModel
from reart_tpu_torch.ops import assignment as A
from reart_tpu_torch.ops import cuda_auction
from reart_tpu_torch.train import FitConfig, engine, fit_base

torch.set_num_threads(1)


@pytest.fixture
def banded_on_cpu(monkeypatch):
    """Admit the banded route at toy scale, a window of 128 in auto mode;
    count the banded solves."""
    monkeypatch.setattr(A, "banded_points_available",
                        lambda n, m, band, device=None: band > 0)
    monkeypatch.setattr(A, "resolve_band",
                        lambda band, n: 128 if band == -1 else band)
    calls = []
    solve = A.auction_solve_banded

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return solve(*args, **kw)

    monkeypatch.setattr(A, "auction_solve_banded", counted)
    return calls


def _fit(tgt_of, n_iter=2, checkpoint_dir=None, snapshot_cb=None, **over):
    """A tiny all-assignment fit: 512 points, 4 frames, 3 parts."""
    n, t, p = 512, 4, 3
    rng = np.random.RandomState(0)
    cano = rng.randn(n, 3).astype(np.float32)
    pcs = np.stack([tgt_of(cano, i, rng) for i in range(t)])
    cfg = FitConfig(n_iter=n_iter, assign_iter=0, use_assign_loss=True,
                    downsample=1, assign_gap=1, start_tau=1.0, end_tau=1.0,
                    **over)
    model = BaseModel(p, t, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    noise = np.random.RandomState(2).gumbel(size=(n_iter, n, p)).astype(
        np.float32)
    _, hist = fit_base(model, cfg, cano, pcs, noise=lambda it: noise[it],
                       device="cpu", checkpoint_dir=checkpoint_dir,
                       checkpoint_every=1, snapshot_cb=snapshot_cb,
                       snapshot_every=1)
    return hist["total_loss"].numpy()


def _aligned(cano, i, rng):
    return (cano + 1e-4 * rng.randn(*cano.shape)).astype(np.float32)


def _reflected(cano, i, rng):
    return (cano * np.float32([-1, 1, 1])).astype(np.float32)


def test_falls_back_on_unaligned_clouds(banded_on_cpu, capsys):
    # reflected targets: the two clouds' curve orders disagree completely,
    # so the band-restricted matching is far off the optimum
    losses = _fit(_reflected)
    out = capsys.readouterr().out
    assert np.isfinite(losses).all()
    assert "banded-LAP guard: banded matched cost" in out
    assert "dense solver" in out
    assert len(banded_on_cpu) == 1  # the probe's solve only


def test_keeps_banded_on_aligned_clouds(banded_on_cpu, capsys):
    # near-coincident clouds: identity-initialised proposals put the
    # predictions on the targets, the banded matching is near exact
    losses = _fit(_aligned)
    assert np.isfinite(losses).all()
    assert "banded-LAP guard" not in capsys.readouterr().out
    assert len(banded_on_cpu) == 3  # the probe, then both LAPs


def test_guard_off_and_explicit_band_take_the_band(banded_on_cpu, capsys):
    _fit(_reflected, assign_band_guard=0.0)
    _fit(_reflected, assign_band=256)  # an explicit window: no guard
    assert "banded-LAP guard" not in capsys.readouterr().out
    assert len(banded_on_cpu) == 4
    _fit(_reflected, assign_band=0)  # dense
    assert len(banded_on_cpu) == 4


def test_reprobe_flips_decision_midfit(banded_on_cpu, monkeypatch, capsys):
    """The probe is faked with call-dependent costs (unaligned at the phase
    start, aligned by the re-probe), so the drift is deterministic; the
    cadence, the decision flip and the solver switch are the engine's."""
    calls = []

    def fake_probe(pc_src, pc_tgt, price, band, sweeps):
        calls.append(band)
        return (1.5, 1.0) if len(calls) == 1 else (1.0, 1.0)

    monkeypatch.setattr(engine, "_band_guard_probe", fake_probe)
    losses = _fit(_aligned, n_iter=8, assign_band_reprobe=4)
    out = capsys.readouterr().out
    assert np.isfinite(losses).all()
    assert calls == [128, 128]  # phase start + one re-probe
    assert "banded-LAP guard: banded matched cost +50.0%" in out  # dense
    assert ("re-probe at iteration 4: matched cost +0.0% vs dense — "
            "switching to the banded solver") in out
    assert len(banded_on_cpu) == 4  # the LAPs of iterations 4-7


def test_guard_decision_survives_a_resume(banded_on_cpu, monkeypatch,
                                          tmp_path, capsys):
    """A fit stopped after its guard chose the dense solver (its last save
    at iteration 2) resumes from fit_state.pkl with that decision and probes
    no more; the same history as a fit never stopped."""
    calls = []

    def fake_probe(pc_src, pc_tgt, price, band, sweeps):
        calls.append(band)
        return 1.5, 1.0

    monkeypatch.setattr(engine, "_band_guard_probe", fake_probe)
    ref = _fit(_aligned, n_iter=6)
    assert len(calls) == 1

    class Killed(Exception):
        pass

    def kill(done, _model):
        if done >= 3:
            raise Killed

    ckpt_dir = str(tmp_path / "fit")
    with pytest.raises(Killed):
        _fit(_aligned, n_iter=6, checkpoint_dir=ckpt_dir, snapshot_cb=kill)
    assert len(calls) == 2
    with open(os.path.join(ckpt_dir, "fit_state.pkl"), "rb") as f:
        assert pickle.load(f)["guard_band"] == 0
    again = _fit(_aligned, n_iter=6, checkpoint_dir=ckpt_dir)
    assert len(calls) == 2  # resumed with the saved decision
    assert "[fit] resuming from iteration 2" in capsys.readouterr().out
    np.testing.assert_array_equal(again, ref)
    assert len(banded_on_cpu) == 0


def test_probe_costs_match_jax():
    rng = np.random.RandomState(3)
    t, n = 2, 256
    src = rng.randn(t, n, 3).astype(np.float32)
    tgt = (src[:, rng.permutation(n)] + 0.05 * rng.randn(t, n, 3)).astype(
        np.float32)
    price = (rng.rand(t, n) * 0.01).astype(np.float32)

    def forward_fn(params, key, tau, cano_pc, fwd_ctx):
        return params["pcs"], None, None

    probe = jax_engine._band_guard_probe(forward_fn, 128, 10, 1.0, 1.0, 100)
    with pltpu.force_tpu_interpret_mode():
        jb, jd = probe({"pcs": jnp.asarray(src)}, None, jnp.asarray(0),
                       None, None, jnp.arange(n), jnp.asarray(tgt),
                       jnp.asarray(price))
    tb, td = engine._band_guard_probe(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(price),
        128, 100)
    np.testing.assert_allclose(tb, float(jb), rtol=1e-5)
    np.testing.assert_allclose(td, float(jd), rtol=1e-5)
    assert tb >= td * 0.9  # the band restricts the dense matching
    assert cuda_auction.auction_solve_banded.launches == 0  # plain on CPU
