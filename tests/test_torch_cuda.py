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
    with pytest.raises(ValueError):
        cuda_auction.auction_solve_resident(
            benefit, torch.zeros((1, 1025), device=cuda), EPS, 10)


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (3, 5, 1), (2, 300, 500),
                                   (1, 33, 4100), (2, 128, 160)])
def test_sweep_kernels_sizes_and_ties(cuda, b, n, m):
    rng = np.random.RandomState(b * n + m)
    if (n, m) == (128, 160):  # small integers: ties in most rows and columns
        benefit = -torch.from_numpy(rng.randint(0, 3, (b, n, m)).astype(
            np.float32))
        price = torch.from_numpy(rng.randint(0, 2, (b, m)).astype(np.float32))
    else:
        benefit, price = -_randn(n, b, n, m).abs(), _randn(m, b, m).abs()
    got = cuda_auction.row_top2(benefit.to(cuda), price.to(cuda))
    ref = cuda_auction.row_top2_plain(benefit, price)
    _same(got, ref, exact={0, 1, 2})
    bid = ref[0] - ref[1] + 0.5
    bid[:, ::3] = float("-inf")
    got = cuda_auction.col_winner_max(bid.to(cuda), ref[2].to(cuda), m)
    _same(got, cuda_auction.col_winner_max_plain(bid, ref[2], m),
          exact={0, 1})


def test_auction_lap_past_the_streamed_window_runs_sweeps(cuda):
    from reart_tpu_torch.ops.assignment import auction_lap

    tgt = _randn(5, 1, 4200, 3)
    src = tgt[:, np.random.RandomState(5).permutation(4200)[:1000]] \
        + 0.05 * _randn(6, 1, 1000, 3)
    cost = torch.cdist(src, tgt)  # 1000 x 4200 > 2048^2
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0, max_sweeps=60,
              return_price=True)
    before = cuda_auction.row_top2.launches
    r2c, price = auction_lap(cost.to(cuda), **kw)
    assert cuda_auction.row_top2.launches > before
    r_ref, p_ref = auction_lap(cost, **kw)  # the plain loop on the CPU
    _same((r2c, price), (r_ref, p_ref), exact={0})


def _streamed_problem(kind, b, n, m):
    """Benefit (B, N, M) in the streamed kernel's window."""
    if kind == "clouds":
        tgt = _randn(m, b, m, 3)
        src = tgt[:, np.random.RandomState(n).permutation(m)[:n]] \
            + 0.05 * _randn(n + 1, b, n, 3)
        return -torch.cdist(src, tgt)
    if kind == "duplicates":  # 8 distinct points: every row ties widely
        base = _randn(3, b, 8, 3)
        return -torch.cdist(base.repeat(1, n // 8, 1),
                            base.repeat(1, m // 8, 1))
    if kind == "all_equal":
        return torch.full((b, n, m), -1.0)
    rng = np.random.RandomState(9)  # small integers
    return -torch.from_numpy(rng.randint(0, 4, (b, n, m)).astype(np.float32))


@pytest.mark.parametrize("kind,b,n,m,sweeps", [
    ("clouds", 2, 700, 1501, 100),      # ragged, M % 4 != 0: scalar loads
    ("clouds", 1, 1024, 2048, 100),     # N < M
    ("clouds", 1, 2048, 2048, 100),     # the window's far corner, B = 1
    ("clouds", 12, 1100, 1100, 100),    # more elements than fit at once
    ("clouds", 2, 1100, 1100, 1),       # one sweep per phase
    ("duplicates", 2, 1024, 1104, 60),
    ("all_equal", 1, 1040, 1040, 20),
    ("integers", 2, 1100, 1200, 40)])
def test_streamed_auction_sizes_ties_and_bound(cuda, kind, b, n, m, sweeps):
    benefit = _streamed_problem(kind, b, n, m).contiguous()
    price = torch.zeros((b, m))
    got = cuda_auction.auction_solve_resident_hbm(
        benefit.to(cuda), price.to(cuda), EPS, sweeps, return_stats=True)
    ref = cuda_auction.auction_solve_resident_hbm_plain(
        benefit, price, EPS, sweeps, return_stats=True)
    _same(got, ref, exact={0, 2})
    # warm-started from the prices it just found
    got2 = cuda_auction.auction_solve_resident_hbm(
        benefit.to(cuda), got[1], EPS, sweeps)
    ref2 = cuda_auction.auction_solve_resident_hbm_plain(
        benefit, ref[1], EPS, sweeps)
    _same(got2, ref2, exact={0})


def test_streamed_auction_unaligned_view_and_stream(cuda):
    """A benefit whose storage starts 4 bytes past a 16-byte boundary takes
    the scalar loads; a launch on a side stream is ordered on that stream."""
    benefit = _streamed_problem("clouds", 1, 1100, 1100).contiguous()
    flat = torch.empty(benefit.numel() + 1, device=cuda)
    flat[1:] = benefit.to(cuda).reshape(-1)
    view = flat[1:].view(1, 1100, 1100)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    price = torch.zeros((1, 1100))
    ref = cuda_auction.auction_solve_resident_hbm_plain(benefit, price, EPS,
                                                        100)
    _same(cuda_auction.auction_solve_resident_hbm(view, price.to(cuda), EPS,
                                                  100), ref, exact={0})
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = benefit.to(cuda, non_blocking=True) * 1.0
        got = cuda_auction.auction_solve_resident_hbm(
            on_side, price.to(cuda), EPS, 100)
    side.synchronize()
    _same(got, ref, exact={0})


def test_streamed_auction_window_and_dispatch(cuda):
    from reart_tpu_torch.ops.assignment import auction_lap

    for n, m in ((1024, 1024), (2048, 2049)):
        with pytest.raises(ValueError):
            cuda_auction.auction_solve_resident_hbm(
                torch.zeros((1, n, m), device=cuda),
                torch.zeros((1, m), device=cuda), EPS, 10)
    cost = -_streamed_problem("clouds", 1, 1100, 1100).to(cuda)
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0, max_sweeps=100)
    counts = lambda: (cuda_auction.auction_solve_resident.launches,
                      cuda_auction.auction_solve_resident_hbm.launches,
                      cuda_auction.row_top2.launches)
    before = counts()
    r2c = auction_lap(cost, **kw)
    after = counts()
    assert after[1] == before[1] + 1 and after[::2] == before[::2]
    swept = auction_lap(cost, use_resident=False, **kw)
    assert counts()[1] == after[1] and counts()[2] > after[2]
    assert torch.equal(r2c, swept)


def _toy_kinematic(device):
    from reart_tpu_torch import cli
    from reart_tpu_torch.data.synth import make_toy_robot_sample
    from reart_tpu_torch.train import FlowContext

    sample = make_toy_robot_sample()
    args = cli.build_parser().parse_args(
        ["robot", "--device", "cpu", "--tree_search", "0"])
    rng = np.random.RandomState(0)
    trans = sample["gt_pose_list"][1:].copy()
    trans[..., :3, 3] += 0.01 * rng.randn(3, 3, 3).astype(np.float32)
    result = {"pred_cano_part": sample["gt_cano_part"],
              "pred_pose_list": trans, "cano_idx": 0,
              "joint_connection": [[1, 0], [2, 0]]}
    params, state = cli.build_kinematic_from_result(
        args, "robot", sample["cano_pc"], result, device=device)
    gt = sample["complete_gt_pc_list"]
    flow_ctx = FlowContext.from_lists(
        [gt[i] for i in range(3)], [gt[i + 1] - gt[i] for i in range(3)],
        device=device)
    return sample, params, state, flow_ctx


def test_fit_kinematic_on_card_matches_cpu(cuda):
    from reart_tpu_torch.train import FitConfig, fit_kinematic

    cfg = FitConfig(n_iter=12, assign_iter=4, assign_gap=2, downsample=2,
                    use_flow_loss=True, use_assign_loss=True)
    hists = {}
    for where in ("cpu", cuda):
        sample, params, state, flow_ctx = _toy_kinematic(where)
        _, h = fit_kinematic(params, state, cfg, sample["pc_list"],
                             flow_ctx=flow_ctx, device=where)
        hists[str(where)] = {k: v.cpu() for k, v in h.items()}
    n_recon = cfg.assign_iter
    for k, ref in hists["cpu"].items():
        got = hists[str(cuda)][k]
        # before the first LAP: Adam steps amplify the ulp between the
        # devices' reductions
        torch.testing.assert_close(got[:n_recon], ref[:n_recon], rtol=1e-3,
                                   atol=1e-7)
        # with LAPs: an epsilon-auction's matching is not unique. Rows in
        # a price war bid the same amount up to rounding, so an ulp in a
        # cost picks another winner and another epsilon-optimal matching,
        # whose assignment loss differs by a few per cent (3% measured)
        torch.testing.assert_close(got[n_recon:], ref[n_recon:], rtol=0.1,
                                   atol=1e-7)


@pytest.mark.parametrize("model", ["base", "kinematic"])
def test_banded_request_on_card_is_turned_away(cuda, model):
    """A LAP past 1024^2 (N = 2304, downsample 2: 1152^2) with assign_band
    other than 0 raises naming its slice; with 0 the fit runs, through the
    streamed kernel."""
    from reart_tpu_torch.models import BaseModel, KinematicModel
    from reart_tpu_torch.models.kinematic import make_kinematic_state
    from reart_tpu_torch.train import FitConfig, fit_base, fit_kinematic

    rng = np.random.RandomState(0)
    cano = rng.randn(2304, 3).astype(np.float32)
    pcs = np.stack([cano + 0.02, cano + 0.04])
    kw = dict(n_iter=3, assign_iter=1, assign_gap=1, downsample=2,
              use_assign_loss=True)

    def run(band):
        cfg = FitConfig(assign_band=band, **kw)
        if model == "base":
            return fit_base(BaseModel(3, 2, device=cuda), cfg, cano, pcs)
        seg = (cano[:, 0] > 0).astype(np.int64)
        state = make_kinematic_state(seg, cano, [(1, 0)], 0, device=cuda)
        params = KinematicModel(
            2, 1, axis_list=np.array([[0, 0, 1]], np.float32),
            theta_list=np.full((2, 1), 0.1, np.float32), device=cuda)
        return fit_kinematic(params, state, cfg, pcs)

    for band in (-1, 512):
        with pytest.raises(NotImplementedError, match="slice 4"):
            run(band)
    before = cuda_auction.auction_solve_resident_hbm.launches
    _, hist = run(0)
    assert cuda_auction.auction_solve_resident_hbm.launches == before + 2
    assert torch.isfinite(hist["total_loss"]).all()


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


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (2, 129, 1025), (3, 33, 5),
                                   (1, 300, 2049)])
def test_nn_topk_ragged_and_m_below_k(cuda, k, b, n, m):
    q, r = _randn(b * n + k, b, n, 3), _randn(m + k, b, m, 3)
    got = cuda_nn.nn_topk(q.to(cuda), r.to(cuda), k)
    _same(got, cuda_nn.nn_topk_plain(q, r, k), exact={1})
    if m < k:  # the missing slots
        assert torch.isinf(got[0][..., m:]).all()
        assert int(got[1][..., m:].abs().max()) == 0


@pytest.mark.parametrize("k", [1, 3, 8])
def test_nn_topk_duplicates_and_all_ties(cuda, k):
    base = _randn(0, 1, 4, 3)
    q, r = base.repeat(1, 50, 1), base.repeat(1, 300, 1)
    got = cuda_nn.nn_topk(q.to(cuda), r.to(cuda), k)
    _same(got, cuda_nn.nn_topk_plain(q, r, k), exact={1})
    zero = torch.zeros((1, 70, 3))
    d, i = cuda_nn.nn_topk(zero.to(cuda), zero.to(cuda), k)
    assert torch.equal(i.cpu(), torch.arange(k).expand(1, 70, k))
    assert float(d.abs().max()) == 0.0


def test_nn_topk_broadcast_ref_is_read_in_place(cuda):
    # query (T, P, N, 3) against ref (T, 1, M, 3), and against one (M, 3)
    q, r = _randn(1, 3, 4, 65, 3), _randn(2, 3, 1, 130, 3)
    full = r.expand(3, 4, 130, 3).reshape(12, 130, 3)
    ref = cuda_nn.nn_topk_plain(q.reshape(12, 65, 3), full, 3)
    got = cuda_nn.nn_topk(q.to(cuda), r.to(cuda), 3)
    _same([g.reshape(12, 65, 3) for g in got], ref, exact={1})
    got1 = cuda_nn.nn_topk(q.to(cuda), r[0, 0].to(cuda), 1)
    ref1 = cuda_nn.nn_topk_plain(q.reshape(12, 65, 3), r[0], 1, ref_div=12)
    _same([g.reshape(12, 65, 1) for g in got1], ref1, exact={1})


def test_batch_past_65535(cuda):
    b = 70000
    q, r = _randn(3, b, 5, 3), _randn(4, b, 7, 3)
    _same(cuda_nn.nn_topk(q.to(cuda), r.to(cuda), 3),
          cuda_nn.nn_topk_plain(q, r, 3), exact={1})
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={1, 2})
    _same(cuda_nn.nn_bidir(q.to(cuda), r.to(cuda)),
          cuda_nn.nn_bidir_plain(q, r), exact={1, 3})


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (400, 20, 20), (2, 129, 1025),
                                   (1, 4097, 3), (2, 33, 2049)])
def test_nn1_coords_and_nn_bidir_ragged(cuda, b, n, m):
    q, r = _randn(b * n, b, n, 3), _randn(m, b, m, 3)
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={1, 2})
    _same(cuda_nn.nn_bidir(q.to(cuda), r.to(cuda)),
          cuda_nn.nn_bidir_plain(q, r), exact={1, 3})


def test_nn1_coords_and_nn_bidir_ties(cuda):
    base = _randn(0, 1, 4, 3)
    q, r = base.repeat(1, 50, 1), base.repeat(1, 300, 1)
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={1, 2})
    _same(cuda_nn.nn_bidir(q.to(cuda), r.to(cuda)),
          cuda_nn.nn_bidir_plain(q, r), exact={1, 3})
    zero = torch.zeros((2, 70, 3), device=cuda)
    assert int(cuda_nn.nn1_coords(zero, zero)[1].max()) == 0
    fd, fi, bd, bi = cuda_nn.nn_bidir(zero, zero)
    assert int(fi.max()) == 0 and int(bi.max()) == 0


def test_nn_topk_rejects_k_past_cap(cuda):
    x = torch.zeros((1, 8, 3), device=cuda)
    with pytest.raises(ValueError):
        cuda_nn.nn_topk(x, x, cuda_nn.MAX_K + 1)


@pytest.mark.parametrize("mode", ["forward", "reverse", "bidirectional"])
def test_chamfer_modes_grads_on_card_match_cpu(cuda, mode):
    from reart_tpu_torch.ops.distance import chamfer

    n, m = (300, 300) if mode == "bidirectional" else (300, 500)
    src, tgt = _randn(10, 2, n, 3), _randn(11, 2, m, 3)
    outs = []
    for dev in ("cpu", cuda):
        s = src.to(dev).detach().requires_grad_(True)
        t = tgt.to(dev).detach().requires_grad_(True)
        d, *idx = chamfer(s, t, bidirectional=mode == "bidirectional",
                          reverse=mode == "reverse", return_index=True)
        d.sum().backward()
        outs.append((d.detach().cpu(), s.grad.cpu(), t.grad.cpu(),
                     [i.cpu() for i in idx]))
    for i_card, i_cpu in zip(outs[1][3], outs[0][3]):
        assert torch.equal(i_card, i_cpu)
    # the scatter-add order differs (atomics on the card)
    for g, r in zip(outs[1][:3], outs[0][:3]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_neighbour_ops_run_on_card(cuda):
    from reart_tpu_torch.ops import (
        blend_anchor_motion,
        knn,
        knn_transfer_labels,
        nearest_neighbor,
    )

    q, r = _randn(20, 150, 3), _randn(21, 400, 3)
    f = 0.1 * _randn(22, 400, 3)
    d, i = nearest_neighbor(q.to(cuda), r.to(cuda))
    d_ref, i_ref = nearest_neighbor(q, r)
    assert torch.equal(i.cpu(), i_ref)
    torch.testing.assert_close(d.cpu(), d_ref, **TOL)
    dk, ik = knn(q.to(cuda), r.to(cuda), 3)
    assert torch.equal(ik.cpu(), knn(q, r, 3)[1])
    out, mask = blend_anchor_motion(q.to(cuda), r.to(cuda), f.to(cuda),
                                    return_mask=True)
    out_ref, mask_ref = blend_anchor_motion(q, r, f, return_mask=True)
    torch.testing.assert_close(out.cpu(), out_ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(mask.cpu(), mask_ref)
    labels = torch.arange(400) % 7
    assert torch.equal(
        knn_transfer_labels(q.to(cuda), r.to(cuda), labels.to(cuda)).cpu(),
        knn_transfer_labels(q, r, labels))


def test_fit_base_default_noise_on_card(cuda):
    from reart_tpu_torch.models import BaseModel
    from reart_tpu_torch.train import FitConfig, fit_base

    cano = _randn(12, 256, 3)
    pcs = torch.stack([cano + 0.02 * i for i in range(1, 4)])
    model = BaseModel(3, 3, generator=torch.Generator().manual_seed(0),
                      device="cpu")  # fit_base moves it to the card
    cfg = FitConfig(n_iter=8, use_assign_loss=True, assign_iter=4,
                    assign_gap=2, downsample=2)
    _, hist = fit_base(model, cfg, cano, pcs, device=cuda)
    assert all(torch.isfinite(v).all() for v in hist.values())
    assert model.proposal_t.device.type == "cuda"


@pytest.mark.parametrize("seed,n_parts", [(0, 6), (1, 4)])
def test_seg_refine_and_graph_stage_on_card_match_cpu(cuda, seed, n_parts):
    """The stages between the fit and the metrics, on the card against the
    CPU from the same labels and poses: labels and edges exact."""
    from reart_tpu_torch import graph
    from reart_tpu_torch.data.synth import make_robot_sample
    from reart_tpu_torch.models import refine_seg_motion

    sample = make_robot_sample(n_frames=5, n_points=2048, n_parts=n_parts,
                               seed=seed)
    rng = np.random.RandomState(seed)
    gt = sample["gt_cano_part"]
    cols = rng.permutation(12)[:n_parts + 1]
    seg = cols[gt]
    seg[(gt == 0) & (sample["cano_pc"][:, 0] < 0)] = cols[n_parts]
    wrong = rng.choice(len(seg), 150, replace=False)
    seg[wrong] = cols[rng.randint(0, n_parts, 150)]
    trans = np.tile(np.eye(4, dtype=np.float32), (4, 12, 1, 1))
    trans[:, cols[:n_parts]] = sample["gt_pose_list"][1:]
    trans[:, cols[n_parts]] = sample["gt_pose_list"][1:, 0]
    trans[..., :3, 3] += 0.002 * rng.randn(4, 12, 3).astype(np.float32)

    outs = []
    for dev in ("cpu", cuda):
        cano = torch.from_numpy(sample["cano_pc"]).to(dev)
        pcs = torch.from_numpy(sample["pc_list"]).to(dev)
        tr = torch.from_numpy(trans).to(dev)
        s = refine_seg_motion(cano, pcs, tr, seg, n_it=2).cpu().numpy()
        refined = s.copy()
        s = graph.denoise_seg_label(s, cano, min_num=20)
        s = graph.merging_wrapper(s, tr, cano, 3e-2, n_it=2)
        edges, cost, uni = graph.mst_wrapper(s, tr, cano, return_cost=True)
        outs.append((refined, s, edges, cost, uni))
    for got, ref in zip(outs[1][:3], outs[0][:3]):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(outs[1][4], outs[0][4])
    # float32 chains through sin/cos/atan2, rounded differently on the card
    np.testing.assert_allclose(outs[1][3], outs[0][3], rtol=1e-4, atol=1e-5)
    assert (outs[1][0] != seg).any()  # the E-step moved points


def test_metrics_on_card_match_cpu(cuda):
    from reart_tpu_torch import metrics
    from reart_tpu_torch.data.synth import make_robot_sample

    sample = make_robot_sample(n_frames=4, n_points=1024, n_parts=4, seed=2)
    pred, obs = sample["gt_pc_list"], sample["pc_list"]
    for reduction in ("mean", "sum"):
        on_card = metrics.compute_chamfer_list(pred, obs, reduction)  # card
        on_cpu = metrics.compute_chamfer_list(pred, obs, reduction,
                                              device="cpu")
        assert on_card == pytest.approx(on_cpu, rel=1e-5)
    trans = sample["gt_pose_list"][1:]
    conn = np.array([[1, 0], [2, 0], [3, 0]])
    complete = np.concatenate([sample["cano_pc"][None], pred])
    kw = dict(complete_pred_pc_list=complete, include_group=True)
    on_card = metrics.energy(pred, obs, trans, conn, sample["gt_cano_part"],
                             **kw)
    on_cpu = metrics.energy(pred, obs, trans, conn, sample["gt_cano_part"],
                            device="cpu", **kw)
    for k in on_cpu:
        assert on_card[k] == pytest.approx(on_cpu[k], rel=1e-4, abs=1e-5), k
