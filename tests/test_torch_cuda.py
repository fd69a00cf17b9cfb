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

from reart_tpu_torch import bench_nn
from reart_tpu_torch.ops import _build, cuda_auction, cuda_fps, cuda_nn

torch.set_num_threads(1)

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


@pytest.mark.parametrize("b,n,m", [(9, 4096, 4096), (3, 4097, 1000),
                                   (2, 129, 513), (1, 1, 600)])
def test_nn1_bidir_ties_across_tiles(cuda, b, n, m):
    # 100 points repeated, the target shifted by 7: exact ties straddle the
    # kernel's 128-row and 512-column tiles both ways
    rep = _randn(7, 1, 100, 3).repeat(b, 50, 1)
    src, tgt = rep[:, :n].contiguous(), rep[:, 7:7 + m].contiguous()
    got = cuda_nn.nn1_bidir_coords(src.to(cuda), tgt.to(cuda))
    _same(got, cuda_nn.nn1_bidir_coords_plain(src, tgt), exact={1, 2, 4, 5})


@pytest.mark.parametrize("b,n,m", [(9, 4096, 4096), (2, 300, 4093),
                                   (2, 77, 130), (3, 1000, 3001)])
def test_blend3_ties_across_slices(cuda, b, n, m):
    # 64 points repeated: each query's 3 nearest are copies 64 apart, in
    # different slices whenever there is more than one
    q = _randn(8, b, n, 3)
    r = _randn(9, 1, 64, 3).repeat(b, -(-m // 64), 1)[:, :m].contiguous()
    f = 0.05 * _randn(10, b, m, 3)
    got = cuda_nn.blend3(q.to(cuda), r.to(cuda), f.to(cuda))
    _same(got, cuda_nn.blend3_plain(q, r, f), exact=set())


@pytest.mark.parametrize("m", [3, 4, 129, 4093])
def test_blend3_anchor_counts_and_far_padding(cuda, m):
    q, r = _randn(11, 2, 257, 3), _randn(12, 2, m, 3)
    f = 0.05 * _randn(13, 2, m, 3)
    r[:, (2 * m) // 3:] = 1e6  # FlowContext's FAR padding, zero flow
    f[:, (2 * m) // 3:] = 0.0
    got = cuda_nn.blend3(q.to(cuda), r.to(cuda), f.to(cuda))
    _same(got, cuda_nn.blend3_plain(q, r, f), exact=set())


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


@pytest.mark.parametrize("n", [1023, 1024, 1025, 2048, 2049, 4097, 8192,
                               8193])
def test_fps_register_layout_boundaries(cuda, n):
    """N at and past the boundaries of the kernel's layout: points a thread
    holds in registers (256 threads up to 2048 points, 512 past, the
    coordinates in shared memory past 8192)."""
    xyz = _randn(n + 1, 2, n, 3)
    mask = torch.ones((2, n), dtype=torch.bool)
    got = cuda_fps.fps(xyz.to(cuda), mask.to(cuda), 300)
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(xyz, mask, 300))


@pytest.mark.parametrize("kind", ["all_equal", "single_point_mask",
                                  "npoint_past_masked_count"])
def test_fps_degenerate_clouds_and_masks(cuda, kind):
    n = 4096
    xyz = _randn(3, 2, n, 3)
    mask = torch.ones((2, n), dtype=torch.bool)
    if kind == "all_equal":
        xyz[:] = 0.25
    elif kind == "single_point_mask":
        mask[:] = False
        mask[0, 4000] = mask[1, 0] = True
    else:
        mask[:] = False
        mask[:, 3000:3040] = True
    got = cuda_fps.fps(xyz.to(cuda), mask.to(cuda), 64)
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(xyz, mask, 64))


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


@pytest.mark.parametrize("b,n,m,sweeps", [
    (3, 1, 7, 100), (2, 100, 1000, 100), (2, 500, 1001, 100),
    (2, 300, 1004, 100), (9, 1024, 1024, 3), (1, 72, 14450, 100),
    (20, 512, 512, 100)])
def test_auction_cluster_edge_cases(cuda, b, n, m, sweeps):
    """The cluster kernel's edge cases, prices exact too: one row, N < M, M
    that splits over no count of blocks or lanes, rows left at the sweep
    bound, one slot buffer (two do not fit the shared memory), 20 elements
    (160 blocks, more than the card's 132 SMs)."""
    src, tgt = _randn(n + 7, b, n, 3), _randn(m + 7, b, m, 3)
    benefit = -torch.cdist(src, tgt)
    price = torch.zeros((b, m))
    got = cuda_auction.auction_solve_resident(
        benefit.to(cuda), price.to(cuda), EPS, sweeps)
    ref = cuda_auction.auction_solve_resident_plain(benefit, price, EPS,
                                                    sweeps)
    _same(got, ref, exact={0, 1})


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


@pytest.mark.parametrize("b,n,m,sweeps,ties", [
    (1, 2049, 2050, 100, False), (2, 2100, 2101, 100, False),
    (2, 2100, 2200, 3, False), (2, 2050, 2100, 200, True),
    (1, 3000, 12000, 100, False), (20, 2100, 2100, 100, False)])
def test_auction_large_edge_cases(cuda, b, n, m, sweeps, ties):
    """The large kernel (one launch past 2048^2) against its plain version
    run on the card, row_to_col, prices and stats exact: N < M, M % 4 != 0
    (one value at a time), rows left at the sweep bound, integer-cost ties,
    one slot buffer, 20 elements (160 blocks, more than the card's 132
    SMs)."""
    if ties:
        rng = np.random.RandomState(b * n + m)
        benefit = -torch.from_numpy(rng.randint(0, 4, (b, n, m)).astype(
            np.float32))
        eps = (1.0, 0.1, 0.01)
    else:
        benefit = -torch.cdist(_randn(n + 11, b, n, 3),
                               _randn(m + 11, b, m, 3))
        eps = EPS
    benefit, price = benefit.to(cuda), torch.zeros((b, m), device=cuda)
    got = cuda_auction.auction_solve_large(benefit, price, eps, sweeps,
                                           return_stats=True)
    ref = cuda_auction.auction_solve_large_plain(benefit, price, eps, sweeps,
                                                 return_stats=True)
    _same(got, tuple(r.cpu() for r in ref), exact={0, 1, 2})
    if sweeps == 3:
        assert (got[0] < 0).any()


def test_auction_large_rejects_within_2048(cuda):
    benefit = torch.zeros((1, 2048, 2048), device=cuda)
    with pytest.raises(ValueError):
        cuda_auction.auction_solve_large(
            benefit, torch.zeros((1, 2048), device=cuda), EPS, 10)


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
    """Past 2048^2 the sweep kernels run under use_resident=False, and by
    default where the large kernel's state does not fit a block's shared
    memory (M = 15000); where it fits (M = 4200) the default route is one
    launch of auction_solve_large. Every route equals the plain loop on the
    CPU."""
    from reart_tpu_torch.ops.assignment import auction_lap

    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0, max_sweeps=60,
              return_price=True)
    for n, m in ((1000, 4200), (300, 15000)):  # both > 2048^2
        tgt = _randn(5, 1, m, 3)
        src = tgt[:, np.random.RandomState(5).permutation(m)[:n]] \
            + 0.05 * _randn(6, 1, n, 3)
        cost = torch.cdist(src, tgt)
        r_ref, p_ref = auction_lap(cost, **kw)  # the plain loop on the CPU
        fits = cuda_auction.large_available(n, m, cuda)
        assert fits == (m == 4200)
        for use_resident in (None, False):
            sweeps = cuda_auction.row_top2.launches
            large = cuda_auction.auction_solve_large.launches
            r2c, price = auction_lap(cost.to(cuda), use_resident=use_resident,
                                     **kw)
            one_launch = fits and use_resident is None
            assert (cuda_auction.auction_solve_large.launches - large
                    == int(one_launch))
            assert (cuda_auction.row_top2.launches > sweeps) != one_launch
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
    ("integers", 2, 1100, 1200, 40),
    ("clouds", 2, 1100, 1203, 100),     # M % 4 != 0
    ("clouds", 20, 1100, 1100, 100),    # 160 blocks: two waves
    ("clouds", 1, 1025, 1025, 100),     # the window's lower edge
    ("clouds", 1, 80, 14248, 100)])     # the largest M whose state fits
def test_streamed_auction_sizes_ties_and_bound(cuda, kind, b, n, m, sweeps):
    """Row_to_col, prices and stats exact (the cluster design's sweeps are
    the plain version's, bid for bid), cold and warm-started."""
    benefit = _streamed_problem(kind, b, n, m).contiguous()
    price = torch.zeros((b, m))
    got = cuda_auction.auction_solve_resident_hbm(
        benefit.to(cuda), price.to(cuda), EPS, sweeps, return_stats=True)
    ref = cuda_auction.auction_solve_resident_hbm_plain(
        benefit, price, EPS, sweeps, return_stats=True)
    _same(got, ref, exact={0, 1, 2})
    # warm-started from the prices it just found
    got2 = cuda_auction.auction_solve_resident_hbm(
        benefit.to(cuda), got[1], EPS, sweeps)
    ref2 = cuda_auction.auction_solve_resident_hbm_plain(
        benefit, ref[1], EPS, sweeps)
    _same(got2, ref2, exact={0, 1})


def test_streamed_auction_one_column_past_its_state(cuda):
    """At N = 80 the cluster state fits up to M = 14248; one column past it
    the wrapper raises and auction_lap sweeps, equal to use_resident=False
    and to the plain version."""
    from reart_tpu_torch.ops.assignment import auction_lap

    assert cuda_auction.resident_hbm_available(80, 14248)
    assert not cuda_auction.resident_hbm_available(80, 14249)
    cost = -_streamed_problem("clouds", 1, 80, 14249).to(cuda)
    with pytest.raises(ValueError):
        cuda_auction.auction_solve_resident_hbm(
            -cost, torch.zeros((1, 14249), device=cuda), EPS, 10)
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0, max_sweeps=100)
    launches = (cuda_auction.auction_solve_resident_hbm.launches,
                cuda_auction.row_top2.launches)
    r2c, price = auction_lap(cost, return_price=True, **kw)
    assert cuda_auction.auction_solve_resident_hbm.launches == launches[0]
    assert cuda_auction.row_top2.launches > launches[1]
    swept = auction_lap(cost, return_price=True, use_resident=False, **kw)
    _same((r2c, price), tuple(t.cpu() for t in swept), exact={0, 1})


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
    """A LAP past 1024^2 (N = 2304, downsample 2: 1152^2) takes the banded
    solve with assign_band -1 (auto: a window of 512) or 512 and the guard
    off, and the streamed dense kernel with 0; nothing is turned away."""
    from reart_tpu_torch.models import BaseModel, KinematicModel
    from reart_tpu_torch.models.kinematic import make_kinematic_state
    from reart_tpu_torch.train import FitConfig, fit_base, fit_kinematic

    rng = np.random.RandomState(0)
    cano = rng.randn(2304, 3).astype(np.float32)
    pcs = np.stack([cano + 0.02, cano + 0.04])
    kw = dict(n_iter=3, assign_iter=1, assign_gap=1, downsample=2,
              use_assign_loss=True, assign_band_guard=0.0)

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
        before = cuda_auction.auction_solve_banded.launches
        _, hist = run(band)
        assert cuda_auction.auction_solve_banded.launches == before + 2
        assert torch.isfinite(hist["total_loss"]).all()
    before = cuda_auction.auction_solve_resident_hbm.launches
    _, hist = run(0)
    assert cuda_auction.auction_solve_resident_hbm.launches == before + 2
    assert torch.isfinite(hist["total_loss"]).all()


def _sorted_clouds(b, n, noise, seed):
    """Clouds sorted along the Hilbert curve, as the banded solve takes
    them."""
    from reart_tpu_torch.ops.assignment import _curve_sort

    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, 3).astype(np.float32)
    tgt = (src + noise * rng.randn(b, n, 3)).astype(np.float32)
    s, t, _, _ = _curve_sort(torch.from_numpy(src), torch.from_numpy(tgt),
                             1024, None)
    return s, t


def _banded_same(cuda, src, tgt, price, eps, sweeps, w, tile=None,
                 carry=False, on_card=False):
    """Kernel against its plain version (on the CPU, or on the card for
    large problems): row_to_col, prices and stats equal."""
    got = cuda_auction.auction_solve_banded(
        src.to(cuda), tgt.to(cuda), price.to(cuda), eps, sweeps, w, tile,
        carry, return_stats=True)
    where = cuda if on_card else "cpu"
    ref = cuda_auction.auction_solve_banded_plain(
        src.to(where), tgt.to(where), price.to(where), eps, sweeps, w, tile,
        carry, return_stats=True)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g.cpu(), r.cpu()), f"output {i} differs"
    return got


@pytest.mark.parametrize("b,n,w,tile,sweeps,carry", [
    (2, 64, 64, 8, 2000, False),      # full band, tile 8
    (2, 64, 64, 8, 2000, True),
    (1, 256, 128, None, 100, False),  # B = 1
    (9, 512, 128, 64, 100, False),    # B = 9
    (3, 384, 128, 48, 100, True),     # carry on, tiles of 48
    (2, 96, 40, 8, 30, False),        # unaligned window
])
def test_banded_auction_sizes(cuda, b, n, w, tile, sweeps, carry):
    src, tgt = _sorted_clouds(b, n, 0.05, n + b)
    eps = (1e-2, 1e-3, 1e-4) if carry else (5e-3, 1e-4)
    _banded_same(cuda, src, tgt, torch.zeros(b, n), eps, sweeps, w, tile,
                 carry)


def test_banded_auction_bound_fallback_and_warm(cuda):
    """max_sweeps 1 and 0 leave rows to the in-band fallback; a converged
    warm start carried over a repeated epsilon runs no sweep."""
    src, tgt = _sorted_clouds(2, 256, 1.0, 1)
    zero = torch.zeros(2, 256)
    for sweeps in (0, 1):
        r, _, st = _banded_same(cuda, src, tgt, zero, (1e-4,), sweeps, 128)
        assert int(st[..., 0].max()) == sweeps
    # a full band converges (a narrow one can leave rows that never find a
    # free column in their window: its phases run to the bound)
    src, tgt = _sorted_clouds(2, 256, 0.02, 2)
    _, p, st = _banded_same(cuda, src, tgt, zero, (5e-3, 1e-4), 2000, 256)
    assert int(st[..., 0].max()) < 2000
    _, _, st = _banded_same(cuda, src, tgt, p.cpu(), (1e-4, 1e-4), 2000, 256,
                            carry=True)
    assert int(st[:, 1, 0].max()) == 0


# config: the cluster design's (slot buffers, target points in shared
# memory), or "global"
@pytest.mark.parametrize("b,n,w,carry,config", [
    (1, 2048, 128, False, (2, 1)),         # the narrowest window
    (1, 2048, 2048 - 128, False, (2, 1)),  # the widest below M
    (3, 2048, 512, False, (2, 1)),
    (1, 6144, 512, False, (1, 1)),         # one slot buffer
    (1, 6656, 512, False, (2, 0)),         # the points in device memory
    (1, 8192, 512, False, (1, 0)),         # both
    (1, 8192, 512, True, (1, 0)),
    (1, 12288, 256, False, "global"),      # past the cluster design's state
])
def test_banded_auction_edges_and_routes(cuda, b, n, w, carry, config):
    """The banded solve at its window's edges, in each configuration of the
    cluster design and past its shared memory, through the design and
    configuration the wrapper picks, against the plain version on the card:
    row_to_col, prices and stats equal."""
    from reart_tpu_torch.ops.assignment import band_tile

    tile = band_tile(n)
    if config == "global":
        assert cuda_auction.banded_route(n, n, tile) == "global"
    else:
        assert cuda_auction.banded_route(n, n, tile) == "shared"
        got = cuda_auction.cluster_config("banded", n, n, tile)
        assert got[:2] == config
        assert got == cuda_auction.cluster_plan("banded", n, n, tile)
    src, tgt = _sorted_clouds(b, n, 0.05, n + w)
    eps = (1e-2, 1e-3, 1e-4) if carry else (5e-3, 1e-4)
    _banded_same(cuda, src, tgt, torch.zeros(b, n), eps, 100, w,
                 carry=carry, on_card=True)


@pytest.mark.parametrize("kernel,n,ms,tile", [
    ("resident_hbm", 80, range(14000, 14300), 0),
    ("resident_hbm", 2048, [2048], 0),
    ("large", 4096, range(8700, 12200, 7), 0),
    ("banded", None, range(2048, 12289, 256), 256),
])
def test_cluster_plan_matches_the_library(cuda, kernel, n, ms, tile):
    """The size gates' copy of the cluster kernels' shared-memory layout
    (cuda_auction.cluster_plan) takes what the library takes, across the
    gates' edges."""
    for m in ms:
        key = (kernel, m if n is None else n, m, tile)
        assert cuda_auction.cluster_config(*key) == \
            cuda_auction.cluster_plan(*key), key


def test_banded_auction_large_and_views(cuda):
    """(2, 2048, 2048), w 512 against the plain version on the card; a
    non-contiguous input (the wrapper copies it) gives the same."""
    src, tgt = _sorted_clouds(2, 2048, 0.02, 3)
    price = torch.from_numpy(
        np.random.RandomState(4).rand(2, 2048).astype(np.float32) * 0.01)
    got = _banded_same(cuda, src, tgt, price, (5e-3, 1e-4), 100, 512,
                       on_card=True)
    wide = torch.zeros(2, 2048, 6)
    wide[..., ::2] = src
    view = wide.to(cuda)[..., ::2]
    assert not view.is_contiguous()
    again = cuda_auction.auction_solve_banded(
        view, tgt.to(cuda), price.to(cuda), (5e-3, 1e-4), 100, 512,
        return_stats=True)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_auction_lap_points_on_card_matches_cpu(cuda):
    from reart_tpu_torch.ops.assignment import auction_lap_points

    rng = np.random.RandomState(5)
    src = torch.from_numpy(rng.randn(3, 512, 3).astype(np.float32))
    tgt = src[:, torch.from_numpy(rng.permutation(512))] + 0.01
    price = torch.from_numpy(rng.rand(3, 512).astype(np.float32) * 0.01)
    for rec in (False, True):
        kw = dict(band=128, price=price, return_price=True, nn_recenter=rec)
        got = auction_lap_points(src.to(cuda), tgt.to(cuda),
                                 **dict(kw, price=price.to(cuda)))
        ref = auction_lap_points(src, tgt, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)


def test_chamfer_grads_on_card_match_cpu(cuda):
    from reart_tpu_torch.ops.distance import chamfer_loss

    src, tgt = _randn(10, 2, 300, 3), _randn(11, 2, 500, 3)
    grads = []
    for dev in ("cpu", cuda):
        s = src.to(dev).detach().requires_grad_(True)
        t = tgt.to(dev).detach().requires_grad_(True)
        chamfer_loss(s, t).backward()
        grads.append((s.grad.cpu(), t.grad.cpu()))
    # the same winners, elementwise residuals and the scatter's fixed order
    # of additions on both devices: the same bits
    for g, r in zip(grads[1], grads[0]):
        assert torch.equal(g, r)


def test_chamfer_backward_is_bit_identical_across_calls(cuda):
    from reart_tpu_torch.ops.distance import chamfer_loss

    # a sparse source against a dense target: each source point is the
    # reverse winner of ~16 target points, a long sum in its gradient
    src, tgt = _randn(14, 3, 256, 3), _randn(15, 3, 4096, 3)
    grads = []
    for _ in range(2):
        s = src.to(cuda).requires_grad_(True)
        t = tgt.to(cuda).requires_grad_(True)
        chamfer_loss(s, t).backward()
        grads.append((s.grad.cpu(), t.grad.cpu()))
    for g, r in zip(*grads):
        assert torch.equal(g, r)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (2, 129, 1025), (3, 33, 5),
                                   (1, 300, 2049)])
def test_nn_topk_ragged_and_m_below_k(cuda, k, b, n, m):
    q, r = _randn(b * n + k, b, n, 3), _randn(m + k, b, m, 3)
    got = cuda_nn.nn_topk(q.to(cuda), r.to(cuda), k)
    _same(got, cuda_nn.nn_topk_plain(q, r, k), exact={0, 1})
    if m < k:  # the missing slots
        assert torch.isinf(got[0][..., m:]).all()
        assert int(got[1][..., m:].abs().max()) == 0


@pytest.mark.parametrize("k", [1, 3, 8])
def test_nn_topk_duplicates_and_all_ties(cuda, k):
    base = _randn(0, 1, 4, 3)
    q, r = base.repeat(1, 50, 1), base.repeat(1, 300, 1)
    got = cuda_nn.nn_topk(q.to(cuda), r.to(cuda), k)
    _same(got, cuda_nn.nn_topk_plain(q, r, k), exact={0, 1})
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
    _same([g.reshape(12, 65, 3) for g in got], ref, exact={0, 1})
    got1 = cuda_nn.nn_topk(q.to(cuda), r[0, 0].to(cuda), 1)
    ref1 = cuda_nn.nn_topk_plain(q.reshape(12, 65, 3), r[0], 1, ref_div=12)
    _same([g.reshape(12, 65, 1) for g in got1], ref1, exact={0, 1})


def test_batch_past_65535(cuda):
    b = 70000
    q, r = _randn(3, b, 5, 3), _randn(4, b, 7, 3)
    _same(cuda_nn.nn_topk(q.to(cuda), r.to(cuda), 3),
          cuda_nn.nn_topk_plain(q, r, 3), exact={0, 1})
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={0, 1, 2})
    _same(cuda_nn.nn_bidir(q.to(cuda), r.to(cuda)),
          cuda_nn.nn_bidir_plain(q, r), exact={0, 1, 2, 3})


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (400, 20, 20), (2, 129, 1025),
                                   (1, 4097, 3), (2, 33, 2049),
                                   # N != M both ways, no size a multiple of
                                   # a tile, B = 1, the graph stage's
                                   # (P^2, 20, 20) at P = 7 and 2
                                   (2, 300, 1500), (2, 1500, 300),
                                   (3, 97, 211), (1, 4096, 4096),
                                   (49, 20, 20), (4, 20, 20), (5, 3, 31)])
def test_nn1_coords_and_nn_bidir_ragged(cuda, b, n, m):
    q, r = _randn(b * n, b, n, 3), _randn(m, b, m, 3)
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={0, 1, 2})
    _same(cuda_nn.nn_bidir(q.to(cuda), r.to(cuda)),
          cuda_nn.nn_bidir_plain(q, r), exact={0, 1, 2, 3})


def test_nn1_coords_and_nn_bidir_ties(cuda):
    base = _randn(0, 1, 4, 3)
    q, r = base.repeat(1, 50, 1), base.repeat(1, 300, 1)
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={0, 1, 2})
    _same(cuda_nn.nn_bidir(q.to(cuda), r.to(cuda)),
          cuda_nn.nn_bidir_plain(q, r), exact={0, 1, 2, 3})
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


# ---------------------------------------------------------------------------
# ball_query and the correspondence backbone
# ---------------------------------------------------------------------------

def _ball_same(cuda, radius, k, xyz, new_xyz):
    got = cuda_nn.ball_query(radius, k, xyz.to(cuda), new_xyz.to(cuda))
    ref = cuda_nn.ball_query_plain(radius, k, xyz, new_xyz)
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), ref)
    return ref


@pytest.mark.parametrize("b,n,s,radius,k", [
    (1, 1, 1, 0.5, 4), (2, 31, 7, 0.3, 8), (3, 601, 97, 0.1, 128),
    (2, 1024, 512, 0.05, 32), (1, 4097, 9, 0.2, 64), (2, 20, 5, 10.0, 32)])
def test_ball_query_ragged(cuda, b, n, s, radius, k):
    rng = np.random.RandomState(n)
    xyz = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    new_xyz = torch.from_numpy(rng.rand(b, s, 3).astype(np.float32))
    _ball_same(cuda, radius, k, xyz, new_xyz)


def test_ball_query_edges_and_duplicates(cuda):
    """An empty ball, exactly k hits, one hit, a point exactly at the
    radius (outside), and a cloud in which every point appears twice."""
    k, radius = 8, 0.25
    xyz = torch.full((1, 70, 3), 5.0)
    xyz[0, :, 0] += torch.arange(70)
    xyz[0, 10:10 + k] = 1.0
    xyz[0, 30] = torch.tensor([-3.0, 0.0, 0.0])
    xyz[0, 40] = torch.tensor([0.25, 0.0, 0.0])
    xyz[0, 41] = torch.tensor([0.0, 0.2499999, 0.0])
    new_xyz = torch.tensor([[[-9.0, -9.0, -9.0], [1.0, 1.0, 1.0],
                             [-3.0, 0.1, 0.0], [0.0, 0.0, 0.0]]])
    ref = _ball_same(cuda, radius, k, xyz, new_xyz)
    assert ref[0, 0].tolist() == [0] * k
    assert ref[0, 1].tolist() == list(range(10, 10 + k))
    assert ref[0, 2].tolist() == [30] * k and ref[0, 3].tolist() == [41] * k
    dup = torch.from_numpy(np.random.RandomState(0).rand(2, 130, 3).astype(
        np.float32)).repeat(1, 2, 1)
    _ball_same(cuda, 0.2, 16, dup, dup[:, 5:45].contiguous())


def test_ball_query_view_stream_and_large_grid(cuda):
    """A cloud that is a strided view (the wrapper copies it), a launch on
    a side stream, and B x S centroids in blocks of 16 or fewer: past the
    65,535 blocks of one grid row."""
    rng = np.random.RandomState(1)
    wide = torch.from_numpy(rng.rand(2, 300, 4).astype(np.float32))
    xyz, new_xyz = wide[..., 1:], wide[:, :40, 1:]
    assert not xyz.is_contiguous()
    ref = _ball_same(cuda, 0.2, 16, xyz, new_xyz)
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = xyz.to(cuda, non_blocking=True) * 1.0
        got = cuda_nn.ball_query(0.2, 16, on_side, new_xyz.to(cuda))
    side.synchronize()
    assert torch.equal(got.cpu(), ref)
    many = torch.from_numpy(rng.rand(2100, 64, 3).astype(np.float32))
    cents = torch.from_numpy(rng.rand(2100, 512, 3).astype(np.float32))
    before = cuda_nn.ball_query.launches
    _ball_same(cuda, 0.3, 8, many, cents)
    assert cuda_nn.ball_query.launches == before + 1
    with pytest.raises(ValueError):
        cuda_nn.ball_query(0.3, 8, many.to(cuda), cents)  # two devices
    with pytest.raises(ValueError):
        cuda_nn.ball_query(0.3, 8, many.to(cuda).double(),
                           cents.to(cuda).double())


@pytest.mark.parametrize("n", [1024, 360])
def test_backbone_on_card_matches_cpu(cuda, n):
    """The same weights and clouds through the backbone on the card and on
    the CPU: running mode and batch mode (with its moments) within rtol
    1e-3, atol 5e-4 (float32 sums in another order through 25 layers; a
    small batch deviation amplifies rounding). n = 360 is fewer points than
    SA1's 512 centroids."""
    from reart_tpu_torch.data.synth import make_robot_sample
    from reart_tpu_torch.models.pointnet2 import PointNet2Msg2

    pcs = make_robot_sample(n_frames=2, n_points=n, n_parts=4,
                            seed=1)["complete_pc_list"]
    xyz = torch.from_numpy(pcs / np.linalg.norm(pcs, axis=-1).max())
    cpu_model = PointNet2Msg2(device="cpu",
                              generator=torch.Generator().manual_seed(0))
    card_model = PointNet2Msg2()  # the card by default
    assert next(card_model.parameters()).device.type == "cuda"
    card_model.load_state_dict(cpu_model.state_dict())
    for mode in ("running", "batch"):
        s_cpu, s_card = [], []
        with torch.no_grad():
            ref = cpu_model(xyz, bn_mode=mode, stats_out=s_cpu)
            got = card_model(xyz.to(cuda), bn_mode=mode, stats_out=s_card)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-3, atol=5e-4)
        for (m, v), (m_ref, v_ref) in zip(s_card, s_cpu):
            torch.testing.assert_close(m.cpu(), m_ref, rtol=1e-3, atol=1e-4)
            torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-5)


def test_corr_training_steps_on_card(cuda):
    """Three training steps on the card: finite losses, the kernels
    launched (5 ball queries, 2 FPS, 2 k-NN searches a step), weights and
    running statistics moved."""
    from reart_tpu_torch.data.synth import make_robot_sample
    from reart_tpu_torch.train.corr import CorrTrainConfig, train_corr

    pcs = make_robot_sample(n_frames=3, n_points=1024, n_parts=4,
                            seed=1)["complete_pc_list"]
    frames = pcs / np.linalg.norm(pcs, axis=-1).max()
    cfg = CorrTrainConfig(steps=3, batch=2, n_points=256, dispatch_chunk=3)
    counts = {w: w.launches for w in (cuda_nn.ball_query, cuda_fps.fps,
                                      cuda_nn.nn_topk)}
    model, losses = train_corr(0, frames, cfg)  # the card by default
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert cuda_nn.ball_query.launches - counts[cuda_nn.ball_query] == 15
    assert cuda_fps.fps.launches - counts[cuda_fps.fps] == 6
    assert cuda_nn.nn_topk.launches - counts[cuda_nn.nn_topk] == 6
    assert float(model.head.running_var.min()) != 1.0
    assert next(model.parameters()).device.type == "cuda"


# ---------------------------------------------------------------------------
# nn_topk and ball_query: every route their launchers can take
# ---------------------------------------------------------------------------

def _topk_launch(q, r, k, qpt, slices, ref_div=1):
    """nn_topk's C entry point with the queries a thread and the slice count
    forced; q (B, N, 3), r (B // ref_div, M, 3) on the card."""

    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    d = torch.empty((b, n, k), dtype=torch.float32, device=q.device)
    i = torch.empty((b, n, k), dtype=torch.int64, device=q.device)
    _build.check_launch("nn_topk", _build.load_library().reart_nn_topk(
        q.data_ptr(), r.data_ptr(), b // ref_div, n * ref_div, m, k, qpt,
        slices, d.data_ptr(), i.data_ptr(), _build.stream_of(q)))
    return d, i


def _topk_case(kind):
    rng = np.random.RandomState(len(kind))
    q = rng.randn(3, 333, 3).astype(np.float32)
    r = rng.randn(3, 1500, 3).astype(np.float32)
    if kind == "ties":  # 43 points repeated: ties across slices and subtiles
        r = np.tile(r[:, :43], (1, 35, 1))[:, :1500]
        q[:, :40] = r[:, 3:43]
    elif kind == "all_equal":
        q, r = np.zeros_like(q), np.zeros_like(r)
    elif kind == "ragged":  # M no multiple of 32 or of any slice count
        r = r[:, :1001]
    elif kind == "m_below_k":
        r = r[:, :5]
    return torch.from_numpy(q), torch.from_numpy(r)


@pytest.mark.parametrize("slices", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("qpt", [1, cuda_nn.NN_QPT])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("kind", ["random", "ties", "all_equal", "ragged",
                                  "m_below_k"])
def test_nn_topk_every_slice_count_and_queries_a_thread(cuda, kind, k, qpt,
                                                        slices):
    q, r = _topk_case(kind)
    got = _topk_launch(q.to(cuda), r.to(cuda), k, qpt, slices)
    _same(got, cuda_nn.nn_topk_plain(q, r, k), exact={0, 1})


@pytest.mark.parametrize("slices", [1, 4, 16])
def test_nn_topk_shared_and_unaligned_reference(cuda, slices):
    # 5 query clouds a reference (folded as one cloud of 5 N queries), and
    # a reference whose first point is 4 bytes past a 16-byte boundary
    q = _randn(1, 10, 77, 3)
    flat = _randn(2, 1 + 2 * 999 * 3)
    r = flat[1:].reshape(2, 999, 3)
    unaligned = flat.to(cuda)[1:].view(2, 999, 3)
    assert unaligned.data_ptr() % 16 != 0 and unaligned.is_contiguous()
    for rr in (r.to(cuda), unaligned):
        for k in (1, 3):
            got = _topk_launch(q.to(cuda), rr, k, 1, slices, ref_div=5)
            _same(got, cuda_nn.nn_topk_plain(q, r, k, ref_div=5),
                  exact={0, 1})


@pytest.mark.parametrize("label,qs,rs,k", [
    ("IK label transfer", (6, 3), (4096, 3), 1),
    ("smoothing neighbourhood", (4096, 3), (4096, 3), 8),
    ("table", (3, 20, 4096, 3), (3, 1, 4096, 3), 1),
    ("backbone SA2 level", (8, 512, 3), (8, 128, 3), 3),
    ("backbone SA1 level", (8, 1024, 3), (8, 512, 3), 3)])
def test_nn_topk_path_shapes_exact(cuda, label, qs, rs, k):
    q, r = _randn(len(label), *qs), _randn(len(label) + 1, *rs)
    if label == "smoothing neighbourhood":
        q = r
    got = cuda_nn.nn_topk(q.to(cuda), r.to(cuda), k)
    qf, rf, ref_div, batch = cuda_nn._flatten_query_ref("nn_topk", q, r)
    ref = [x.reshape(batch + x.shape[-2:])
           for x in cuda_nn.nn_topk_plain(qf, rf, k, ref_div)]
    _same(got, ref, exact={0, 1})


def _ball_launch(radius, k, xyz, new_xyz, warps):
    from reart_tpu_torch.ops import _build

    b, n, s = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    out = torch.empty((b, s, k), dtype=torch.int64, device=xyz.device)
    _build.check_launch("ball_query", _build.load_library().reart_ball_query(
        xyz.data_ptr(), new_xyz.data_ptr(), b, n, s,
        cuda_nn.radius_sq(radius), k, warps, out.data_ptr(),
        _build.stream_of(xyz)))
    return out


@pytest.mark.parametrize("warps", [1, 4, 8, 16])
@pytest.mark.parametrize("b,n,s,radius,k", [
    (2, 601, 97, 0.2, 128),      # whole cloud, ragged
    (1, 16384, 40, 0.05, 128),   # the largest cloud held whole
    (1, 16385, 40, 0.05, 128),   # one past it: tiles of 4096
    (2, 20000, 33, 0.9, 64),     # tiles, most centroids done in the first
    (3, 70, 5, 10.0, 128)])      # more slots than points
def test_ball_query_every_block_and_both_routes(cuda, warps, b, n, s, radius,
                                                k):
    rng = np.random.RandomState(n + s)
    xyz = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    new_xyz = xyz[:, rng.permutation(n)[:s]].contiguous()
    got = _ball_launch(radius, k, xyz.to(cuda), new_xyz.to(cuda), warps)
    assert torch.equal(got.cpu(), cuda_nn.ball_query_plain(radius, k, xyz,
                                                           new_xyz))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ball_query_unaligned_cloud(cuda, offset):
    # a cloud 4, 8 or 12 bytes past a 16-byte boundary: the copy's head and
    # tail go 4 bytes at a time
    rng = np.random.RandomState(offset)
    flat = torch.from_numpy(rng.rand(offset + 2 * 1001 * 3).astype(
        np.float32)).to(cuda)
    xyz = flat[offset:].view(2, 1001, 3)
    assert xyz.data_ptr() % 16 == 4 * offset % 16
    new_xyz = xyz[:, ::13].contiguous()
    got = cuda_nn.ball_query(0.3, 32, xyz, new_xyz)
    assert torch.equal(got.cpu(), cuda_nn.ball_query_plain(
        0.3, 32, xyz.cpu(), new_xyz.cpu()))


# ---------------------------------------------------------------------------
# nn_bidir and nn1_coords: every route their launchers can take
# ---------------------------------------------------------------------------

def _bidir_case_card(kind):
    rng = np.random.RandomState(len(kind))
    src = rng.randn(2, 700, 3).astype(np.float32)
    tgt = rng.randn(2, 1500, 3).astype(np.float32)
    if kind == "ties":  # 13 points repeated: ties across groups and warps
        src = np.tile(src[:, :13], (1, 54, 1))[:, :700]
        tgt = np.tile(src[:, :13], (1, 116, 1))[:, 3:1500]
    elif kind == "all_equal":
        src, tgt = np.zeros_like(src), np.zeros_like(tgt)
    elif kind == "n_above_m":
        src, tgt = tgt[:, :1001], src[:, :333]
    elif kind == "overflow":  # nearly every distance +inf
        src, tgt = src * np.float32(1e20), tgt[:, :77] * np.float32(-1e20)
    return torch.from_numpy(src), torch.from_numpy(tgt)


@pytest.mark.parametrize("warps,run,blocks", [
    (1, 1, 1), (2, 3, 2), (4, 16, 1), (8, 16, 3), (8, 7, 16), (1, 16, 4),
    (8, 16, 264), (4, 5, 10 ** 6)])
@pytest.mark.parametrize("kind", ["random", "ties", "all_equal",
                                  "n_above_m", "overflow"])
def test_nn_bidir_every_route(cuda, kind, warps, run, blocks):
    src, tgt = _bidir_case_card(kind)
    got = bench_nn.bidir_launch(_build.load_library(), src.to(cuda),
                                tgt.to(cuda), force=(warps, run, blocks))
    _same(got, cuda_nn.nn_bidir_plain(src, tgt), exact={0, 1, 2, 3})


@pytest.mark.parametrize("plan", [
    ("packed", 8, 1), ("packed", 8, 8), ("packed", 16, 3), ("packed", 32, 1),
    ("packed", 32, 5), ("topk", 1, 1), ("topk", 1, 16),
    ("topk", cuda_nn.NN_QPT, 4)])
@pytest.mark.parametrize("b,n,m", [(49, 7, 8), (9, 4, 3), (17, 8, 1)])
def test_nn1_coords_every_route(cuda, plan, b, n, m):
    q, r = _randn(b + n, b, n, 3), _randn(m, b, m, 3)
    r[:, -1] = r[:, 0]   # a tie with the lowest index
    got = bench_nn.coords_launch(_build.load_library(), q.to(cuda),
                                 r.to(cuda), plan)
    _same(got, cuda_nn.nn1_coords_plain(q, r), exact={0, 1, 2})


@pytest.mark.parametrize("p", [20, 7, 2])
def test_nn1_coords_graph_stage_pairs(cuda, p):
    # the spatial cost's (P^2, 20, 20): every ordered pair of P parts'
    # anchors, the diagonal pairs all ties at distance 0
    a = _randn(p, p, 20, 3)
    q = a[:, None].expand(p, p, 20, 3).reshape(p * p, 20, 3).contiguous()
    r = a[None].expand(p, p, 20, 3).reshape(p * p, 20, 3).contiguous()
    assert cuda_nn.nn1_coords_plan(p * p, 20, 20, 132)[:2] == ("packed", 32)
    _same(cuda_nn.nn1_coords(q.to(cuda), r.to(cuda)),
          cuda_nn.nn1_coords_plain(q, r), exact={0, 1, 2})
