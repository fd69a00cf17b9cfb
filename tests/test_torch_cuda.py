"""Kernel-vs-plain edge cases of reart_tpu_torch's CUDA kernels, on the card.

Marked `cuda`: each test skips without a CUDA device (decided in the
`cuda` fixture, not at import). On a machine with a card and no jax run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax). chip_smoke.py checks the
kernels at the fit's shapes; these tests cover ragged sizes, ties and
degenerate inputs. Indices must be equal; floats within rtol/atol 1e-6
(same formula and order of additions, no FMA contraction)."""

import numpy as np
import pytest
import torch

from reart_tpu_torch.ops import cuda_auction, cuda_fps, cuda_nn

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _same(got, ref, exact):
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.cpu()
        if i in exact:
            assert torch.equal(g, r), f"output {i} differs"
        else:
            torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (3, 1, 5), (2, 129, 1025),
                                   (1, 4097, 3), (2, 33, 2049)])
def test_nn1_bidir_ragged(cuda, b, n, m):
    src, tgt = _randn(b * n, b, n, 3), _randn(m, b, m, 3)
    got = cuda_nn.nn1_bidir_coords(src.to(cuda), tgt.to(cuda))
    _same(got, cuda_nn.nn1_bidir_coords_plain(src, tgt), exact={1, 2, 4, 5})


def test_nn1_bidir_ties(cuda):
    # 4 distinct points repeated: every query has 4+ equidistant winners
    base = _randn(0, 1, 4, 3)
    src = base.repeat(1, 50, 1)
    tgt = base.repeat(1, 300, 1)
    got = cuda_nn.nn1_bidir_coords(src.to(cuda), tgt.to(cuda))
    _same(got, cuda_nn.nn1_bidir_coords_plain(src, tgt), exact={1, 2, 4, 5})


@pytest.mark.parametrize("b,n,m", [(1, 1, 3), (2, 130, 1025), (1, 64, 3000)])
def test_blend3_ragged(cuda, b, n, m):
    q, r = _randn(1, b, n, 3), _randn(2, b, m, 3)
    f = 0.1 * _randn(3, b, m, 3)
    got = cuda_nn.blend3(q.to(cuda), r.to(cuda), f.to(cuda))
    _same(got, cuda_nn.blend3_plain(q, r, f), exact=set())


def test_blend3_duplicate_and_far_anchors(cuda):
    q = _randn(4, 1, 200, 3)
    r = _randn(5, 1, 5, 3).repeat(1, 40, 1)  # every distance ties 40 ways
    f = 0.1 * _randn(6, 1, 200, 3)
    r[:, 100:] = 1e6
    f[:, 100:] = 0.0
    got = cuda_nn.blend3(q.to(cuda), r.to(cuda), f.to(cuda))
    _same(got, cuda_nn.blend3_plain(q, r, f), exact=set())


@pytest.mark.parametrize("b,n,npoint", [(1, 1, 1), (3, 1000, 1000),
                                        (2, 33, 64), (1, 14336, 8)])
def test_fps_sizes(cuda, b, n, npoint):
    xyz = _randn(n, b, n, 3)
    mask = torch.ones((b, n), dtype=torch.bool)
    got = cuda_fps.fps(xyz.to(cuda), mask.to(cuda), npoint)
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(xyz, mask, npoint))


def test_fps_masks_and_ties(cuda):
    xyz = _randn(7, 3, 40, 3).repeat(1, 8, 1)  # duplicates: ties every step
    mask = torch.from_numpy(np.random.RandomState(7).rand(3, 320) < 0.3)
    mask[1] = False                # no masked point: starts at 0
    mask[2, :] = False
    mask[2, 5:9] = True            # fewer masked points than npoint
    got = cuda_fps.fps(xyz.to(cuda), mask.to(cuda), 32)
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(xyz, mask, 32))


def test_fps_rejects_too_many_points(cuda):
    xyz = torch.zeros((1, cuda_fps.MAX_POINTS + 1, 3), device=cuda)
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        cuda_fps.fps(xyz, mask, 4)


EPS = (5e-3, 1e-4)


@pytest.mark.parametrize("b,n,m,sweeps", [
    (1, 1, 2, 100), (2, 300, 500, 100), (3, 256, 256, 3),
    (1, 1024, 1024, 100)])
def test_auction_sizes_and_bound(cuda, b, n, m, sweeps):
    src, tgt = _randn(n, b, n, 3), _randn(m, b, m, 3)
    benefit = -torch.cdist(src, tgt)
    price = torch.zeros((b, m))
    got = cuda_auction.auction_solve_resident(
        benefit.to(cuda), price.to(cuda), EPS, sweeps)
    ref = cuda_auction.auction_solve_resident_plain(benefit, price, EPS,
                                                    sweeps)
    _same(got, ref, exact={0})


def test_auction_integer_costs_tie_everywhere(cuda):
    rng = np.random.RandomState(9)
    benefit = -torch.from_numpy(rng.randint(0, 4, (2, 128, 160)).astype(
        np.float32))
    price = torch.zeros((2, 160))
    got = cuda_auction.auction_solve_resident(
        benefit.to(cuda), price.to(cuda), (1.0, 0.1, 0.01), 200)
    ref = cuda_auction.auction_solve_resident_plain(
        benefit, price, (1.0, 0.1, 0.01), 200)
    _same(got, ref, exact={0})


def test_auction_rejects_past_dense_window(cuda):
    benefit = torch.zeros((1, 1025, 1025), device=cuda)
    with pytest.raises(NotImplementedError):
        cuda_auction.auction_solve_resident(
            benefit, torch.zeros((1, 1025), device=cuda), EPS, 10)


def test_chamfer_grads_on_card_match_cpu(cuda):
    from reart_tpu_torch.ops.distance import chamfer_loss

    src, tgt = _randn(10, 2, 300, 3), _randn(11, 2, 500, 3)
    grads = []
    for dev in ("cpu", cuda):
        s = src.to(dev).detach().requires_grad_(True)
        t = tgt.to(dev).detach().requires_grad_(True)
        chamfer_loss(s, t).backward()
        grads.append((s.grad.cpu(), t.grad.cpu()))
    # the scatter-add order differs (atomics on the card)
    for g, r in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_unported_ops_raise_on_card(cuda):
    from reart_tpu_torch.ops import blend_anchor_motion, nearest_neighbor

    x = torch.zeros((8, 3), device=cuda)
    with pytest.raises(NotImplementedError):
        nearest_neighbor(x, x)
    with pytest.raises(NotImplementedError):
        blend_anchor_motion(x, x, x)


def test_fit_base_default_noise_on_card(cuda):
    from reart_tpu_torch.models import BaseModel
    from reart_tpu_torch.train import FitConfig, fit_base

    cano = _randn(12, 256, 3)
    pcs = torch.stack([cano + 0.02 * i for i in range(1, 4)])
    model = BaseModel(3, 3, generator=torch.Generator().manual_seed(0))
    cfg = FitConfig(n_iter=8, use_assign_loss=True, assign_iter=4,
                    assign_gap=2, downsample=2)
    _, hist = fit_base(model, cfg, cano, pcs, device=cuda)
    assert all(torch.isfinite(v).all() for v in hist.values())
    assert model.proposal_t.device.type == "cuda"
