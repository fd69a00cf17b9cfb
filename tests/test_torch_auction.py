"""Port parity: the dense auction LAP (reart_tpu_torch.ops.assignment and
the plain version of csrc/auction.cu) against the JAX package's auction_lap,
through its jnp phase loop and through the resident Pallas kernel in
interpret mode (the cases of tests/test_assignment.py). row_to_col must be
equal; prices within rtol 1e-5, atol 1e-6. The plain versions of the two
sweep kernels (csrc/auction_sweep.cu) against row_top2_pallas and
col_winner_max_pallas in interpret mode: indices equal, values equal (one
subtraction, a maximum: no rounding differs). The plain version of the
streamed one-launch kernel (csrc/auction_hbm.cu) against the Pallas kernel
in interpret mode at the cases of tests/test_assignment.py::TestResidentHBM
(two column strips, ts=128), cold and warm: row_to_col equal, prices within
rtol 1e-5; and `auction_lap`'s choice of solver by size. The large kernel's
(csrc/auction_large.cu) plain version against the JAX package's sweep loop
(`auction_lap(..., use_resident=False)`, the route it replaces on the
card): row_to_col equal, prices within rtol 1e-6, atol 1e-6."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.assignment import assignment_cost as jax_assignment_cost
from reart_tpu.ops.assignment import auction_lap as jax_auction_lap
from reart_tpu_torch.ops import cuda_auction
from reart_tpu_torch.ops.assignment import assignment_cost, auction_lap

torch.set_num_threads(1)


def _jax_lap(cost, resident, price=None, **kw):
    args = dict(kw, return_price=True, use_resident=resident)
    if price is not None:
        args["price"] = jnp.asarray(price)
    if resident:
        with pltpu.force_tpu_interpret_mode():
            r2c, p = jax_auction_lap(jnp.asarray(cost), **args)
    else:
        r2c, p = jax_auction_lap(jnp.asarray(cost), **args)
    return np.asarray(r2c), np.asarray(p)


def _port_lap(cost, price=None, **kw):  # kw may name use_resident
    r2c, p = auction_lap(torch.from_numpy(cost),
                         price=None if price is None
                         else torch.from_numpy(np.array(price)),
                         return_price=True, **kw)
    return r2c.numpy(), p.numpy()


COLD = dict(eps_min=1e-3, num_scales=2, scale_factor=10.0, max_sweeps=200)
WARM = dict(eps_min=1e-3, num_scales=1, scale_factor=10.0, max_sweeps=200)


@pytest.mark.parametrize("resident", [False, True])
def test_cold_solve_matches_jax(resident):
    cost = np.random.RandomState(3).rand(3, 64, 128).astype(np.float32)
    r_ref, p_ref = _jax_lap(cost, resident, **COLD)
    r, p = _port_lap(cost, **COLD)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [COLD, dict(COLD, max_sweeps=3)],
                         ids=["converged", "sweep_bound"])
def test_sweep_path_matches_jax_and_the_resident_path(kw):
    """auction_lap sweep by sweep (the route of problems past 1024^2)
    against the JAX package's sweep loop and the port's resident route."""
    cost = np.random.RandomState(8).rand(2, 64, 96).astype(np.float32)
    r_ref, p_ref = _jax_lap(cost, False, **kw)
    r, p = _port_lap(cost, use_resident=False, **kw)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)
    r2, p2 = _port_lap(cost, use_resident=True, **kw)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(p, p2)


def _sweep_inputs(kind):
    rng = np.random.RandomState(11)
    if kind == "random":
        benefit = -rng.rand(2, 256, 1024).astype(np.float32)
        price = rng.rand(2, 1024).astype(np.float32)
    else:  # small integers: best and second tie in most rows
        benefit = -rng.randint(0, 3, (2, 256, 1024)).astype(np.float32)
        price = rng.randint(0, 2, (2, 1024)).astype(np.float32)
    return benefit, price


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_row_top2_plain_matches_pallas(kind):
    from reart_tpu.ops.pallas_auction import row_top2_pallas

    benefit, price = _sweep_inputs(kind)
    with pltpu.force_tpu_interpret_mode():
        ref = row_top2_pallas(jnp.asarray(benefit), jnp.asarray(price))
    got = cuda_auction.row_top2(torch.from_numpy(benefit),
                                torch.from_numpy(price))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2].dtype == torch.int64


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_col_winner_max_plain_matches_pallas(kind):
    from reart_tpu.ops.pallas_auction import col_winner_max_pallas

    benefit, price = _sweep_inputs(kind)
    bv, sv, bj = cuda_auction.row_top2(torch.from_numpy(benefit),
                                       torch.from_numpy(price))
    bid = bv - sv + 0.5
    bid[:, ::3] = float("-inf")  # a third of the rows hold a seat
    with pltpu.force_tpu_interpret_mode():
        cb_ref, cw_ref = col_winner_max_pallas(
            jnp.asarray(bid.numpy()), jnp.asarray(bj.numpy().astype(np.int32)),
            1024)
    cb, cw = cuda_auction.col_winner_max(bid, bj, 1024)
    np.testing.assert_array_equal(cb.numpy(), np.asarray(cb_ref))
    got_bid = cb.numpy() > -np.inf
    assert got_bid.any() and not got_bid.all()
    # the winner of a column without a bid means nothing on either side
    np.testing.assert_array_equal(cw.numpy()[got_bid],
                                  np.asarray(cw_ref)[got_bid])
    assert int(cw.numpy()[~got_bid].max()) == 0


def test_sweep_wrappers_check_inputs():
    with pytest.raises(ValueError):
        cuda_auction.row_top2(torch.zeros((1, 4, 8)), torch.zeros((1, 4)))
    with pytest.raises(ValueError):
        cuda_auction.col_winner_max(torch.zeros((1, 4)),
                                    torch.zeros((1, 5), dtype=torch.int64), 8)


@pytest.mark.parametrize("resident", [False, True])
def test_warm_started_solve_matches_jax(resident):
    cost = np.random.RandomState(4).rand(2, 32, 128).astype(np.float32)
    _, price1 = _jax_lap(cost, False, **WARM)
    r_ref, p_ref = _jax_lap(cost, resident, price=price1, **WARM)
    r, p = _port_lap(cost, price=price1, **WARM)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


def test_sweep_bound_then_greedy_completion_matches_jax():
    # a 3-sweep bound leaves rows unassigned: both complete them greedily
    cost = np.random.RandomState(5).rand(2, 64, 64).astype(np.float32)
    kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0, max_sweeps=3)
    r_ref, p_ref = _jax_lap(cost, False, **kw)
    r, p = _port_lap(cost, **kw)
    np.testing.assert_array_equal(r, r_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


def test_resident_plain_marks_unassigned_rows():
    cost = np.random.RandomState(6).rand(1, 64, 64).astype(np.float32)
    benefit = -torch.from_numpy(cost)
    r2c, _ = cuda_auction.auction_solve_resident(
        benefit, torch.zeros((1, 64)), (1e-4,), 2)
    assert (r2c < 0).any() and (r2c < 64).all()


RESIDENT_EDGE_CASES = {
    # seed, shape, integer costs (exact ties across columns and rows)
    "m_not_a_multiple_of_8": (21, (2, 40, 101), False),
    "one_row": (22, (3, 1, 37), False),
    "fewer_rows_than_columns": (23, (2, 20, 300), False),
    "ties_everywhere": (24, (2, 48, 64), True),
}


@pytest.mark.parametrize("case", list(RESIDENT_EDGE_CASES))
def test_resident_plain_matches_pallas_on_edge_cases(case):
    """The plain version of the resident kernel (which the card's cluster
    kernel equals bit for bit) against the JAX package's resident Pallas
    kernel in interpret mode, at the sizes the cluster layout makes risky:
    M that does not split evenly, one row, N < M, and ties everywhere."""
    from reart_tpu.ops.pallas_auction import auction_solve_resident

    seed, shape, ties = RESIDENT_EDGE_CASES[case]
    rng = np.random.RandomState(seed)
    if ties:
        cost = rng.randint(0, 4, shape).astype(np.float32)
        eps = (1.0, 0.1, 0.01)
    else:
        cost = rng.rand(*shape).astype(np.float32)
        eps = (1e-2, 1e-3)
    price = np.zeros((shape[0], shape[2]), np.float32)
    with pltpu.force_tpu_interpret_mode():
        r_ref, p_ref = auction_solve_resident(jnp.asarray(-cost),
                                              jnp.asarray(price), eps, 200)
    r, p = cuda_auction.auction_solve_resident(
        torch.from_numpy(-cost), torch.from_numpy(price), eps, 200)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-5,
                               atol=1e-6)
    assert (r.numpy() >= 0).all()


def test_assignment_cost_matches_jax():
    rng = np.random.RandomState(7)
    cost = rng.rand(2, 16, 20).astype(np.float32)
    r2c = np.stack([rng.permutation(20)[:16] for _ in range(2)])
    ref = np.asarray(jax_assignment_cost(jnp.asarray(cost),
                                         jnp.asarray(r2c)))
    got = assignment_cost(torch.from_numpy(cost), torch.from_numpy(r2c))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_resident_wrapper_checks_inputs():
    benefit = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):  # N > M
        cuda_auction.auction_solve_resident(benefit, torch.zeros((1, 4)),
                                            (1e-3,), 10)
    with pytest.raises(ValueError):  # no epsilon phase
        cuda_auction.auction_solve_resident(
            torch.zeros((1, 4, 8)), torch.zeros((1, 8)), (), 10)


HBM_CASES = {
    # seed, shape, eps_list, warm start
    "cold": (5, (2, 64, 256), (1e-2, 1e-3), False),
    "warm": (6, (2, 32, 384), (1e-3,), True),
    "sweep_bound": (5, (2, 64, 256), (1e-2, 1e-3), False),
}


@pytest.mark.parametrize("case", list(HBM_CASES))
def test_resident_hbm_plain_matches_pallas(case):
    from reart_tpu.ops.pallas_auction import auction_solve_resident_hbm

    seed, shape, eps_list, warm = HBM_CASES[case]
    sweeps = 3 if case == "sweep_bound" else 200
    cost = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    price = np.zeros((shape[0], shape[2]), np.float32)
    if warm:
        _, price = _jax_lap(cost, False, **WARM)
    with pltpu.force_tpu_interpret_mode():
        r_ref, p_ref = auction_solve_resident_hbm(
            jnp.asarray(-cost), jnp.asarray(price), eps_list, sweeps, ts=128)
    r, p, stats = cuda_auction.auction_solve_resident_hbm(
        torch.from_numpy(-cost), torch.from_numpy(np.array(price)), eps_list,
        sweeps, return_stats=True)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-5,
                               atol=1e-6)
    assert ((r.numpy() < 0).any()) == (case == "sweep_bound")
    # sweeps run and rows that bid, per element and phase
    assert stats.shape == (shape[0], len(eps_list), 2)
    assert (stats[..., 0] >= 1).all() and (stats[..., 0] <= sweeps).all()
    assert (stats[..., 1] >= shape[1]).all()
    if case == "sweep_bound":
        assert int(stats[..., 0].max()) == sweeps
    # the two one-launch kernels share one plain version
    r2, p2 = cuda_auction.auction_solve_resident(
        torch.from_numpy(-cost), torch.from_numpy(np.array(price)), eps_list,
        sweeps)
    assert torch.equal(r, r2) and torch.equal(p, p2)


def test_auction_lap_picks_its_solver_by_size(monkeypatch):
    """Up to 1024^2 the resident kernel, up to 2048^2 the streamed one
    (where its cluster state fits a block's shared memory: (100, 10500),
    not (32, 32800)), the sweeps past that; use_resident=False takes no
    one-launch kernel at all and True asks for the resident one."""
    from reart_tpu_torch.ops import assignment

    assert cuda_auction.resident_available(1024, 1024)
    assert not cuda_auction.resident_hbm_available(1024, 1024)
    for n, m in ((2048, 2048), (1024, 2048), (1025, 1025), (700, 1501)):
        assert not cuda_auction.resident_available(n, m)
        assert cuda_auction.resident_hbm_available(n, m), (n, m)
    for n, m in ((2048, 2049), (4096, 4096), (2048, 1024), (1, 2 ** 21)):
        assert not cuda_auction.resident_hbm_available(n, m), (n, m)

    calls = []

    def spy(name):
        def solve(benefit, price, *_):
            calls.append(name)
            return torch.zeros(benefit.shape[:2], dtype=torch.int64), price
        return solve

    monkeypatch.setattr(assignment, "auction_solve_resident", spy("resident"))
    monkeypatch.setattr(assignment, "auction_solve_resident_hbm",
                        spy("streamed"))
    monkeypatch.setattr(assignment, "_auction_phase", spy("sweeps"))
    kw = dict(num_scales=1, max_sweeps=2)
    auction_lap(torch.rand((1, 8, 8)), **kw)
    auction_lap(torch.rand((1, 8, 8)), use_resident=False, **kw)
    auction_lap(torch.rand((1, 100, 10500)), **kw)
    auction_lap(torch.rand((1, 100, 10500)), use_resident=False, **kw)
    auction_lap(torch.rand((1, 100, 10500)), use_resident=True, **kw)
    auction_lap(torch.zeros((1, 1, 2048 ** 2 + 1)), **kw)
    assert calls == ["resident", "sweeps", "streamed", "sweeps", "resident",
                     "sweeps"]


def test_banded_request_by_device():
    """What the port does with a LAP past 1024^2: dense on the CPU whatever
    `assign_band` says (the JAX package's banded path needs the TPU); the
    same request on a CUDA device takes the banded solve unless
    assign_band is 0, which is the only value the JAX package resolves to
    "no band", as it does on the TPU."""
    from reart_tpu.ops.assignment import resolve_band as jax_resolve_band
    from reart_tpu_torch.ops.assignment import (
        banded_points_available,
        resolve_band,
    )

    for n in (2048, 4096, 8192):
        assert jax_resolve_band(0, n) == resolve_band(0, n) == 0
        assert jax_resolve_band(-1, n) == resolve_band(-1, n) > 0
        assert resolve_band(512, n) == 512
    for band in (-1, 0, 512):
        assert not banded_points_available(2048, 2048,
                                           resolve_band(band, 2048), "cpu")
    cuda = torch.device("cuda")
    assert not banded_points_available(2048, 2048, 0, cuda)
    # within 1024^2: never banded
    assert not banded_points_available(1024, 1024, resolve_band(-1, 1024),
                                       cuda)
    for band in (-1, 512):
        assert banded_points_available(2048, 2048, resolve_band(band, 2048),
                                       cuda)


def test_streamed_wrapper_checks_inputs():
    with pytest.raises(ValueError):  # N > M
        cuda_auction.auction_solve_resident_hbm(
            torch.zeros((1, 8, 4)), torch.zeros((1, 4)), (1e-3,), 10)
    with pytest.raises(ValueError):  # nine epsilon phases
        cuda_auction.auction_solve_resident_hbm(
            torch.zeros((1, 4, 8)), torch.zeros((1, 8)), (1e-3,) * 9, 10)
    with pytest.raises(ValueError):  # prices of another width
        cuda_auction.auction_solve_resident_hbm(
            torch.zeros((1, 4, 8)), torch.zeros((1, 7)), (1e-3,), 10)


LARGE_CASES = {
    # seed, shape, integer costs, warm start
    "cold": (31, (2, 48, 64), False, False),
    "warm": (32, (2, 40, 72), False, True),
    "fewer_rows_than_columns": (33, (3, 30, 97), False, False),
    "integer_ties": (34, (2, 40, 56), True, False),
}


@pytest.mark.parametrize("case", list(LARGE_CASES))
def test_large_plain_matches_jax_sweeps(case):
    """auction_solve_large on CPU tensors (its plain version) against the
    JAX package's sweep route, which it replaces on the card past 2048^2:
    the same auction, so row_to_col equal (after the same greedy completion)
    and prices within rtol 1e-6, atol 1e-6."""
    seed, shape, ties, warm = LARGE_CASES[case]
    rng = np.random.RandomState(seed)
    if ties:
        cost = rng.randint(0, 4, shape).astype(np.float32)
        kw = dict(eps_min=0.01, num_scales=3, scale_factor=10.0,
                  max_sweeps=200)
    else:
        cost = rng.rand(*shape).astype(np.float32)
        kw = dict(eps_min=1e-4, num_scales=2, scale_factor=50.0,
                  max_sweeps=100)
    price = np.zeros((shape[0], shape[2]), np.float32)
    if warm:  # the prices of a solve of slightly moved costs
        moved = cost + 0.01 * rng.rand(*shape).astype(np.float32)
        _, price = _jax_lap(moved, False, **kw)
    r_ref, p_ref = _jax_lap(cost, False, price=price, **kw)
    eps_list = tuple(kw["eps_min"] * kw["scale_factor"] ** k
                     for k in range(kw["num_scales"] - 1, -1, -1))
    benefit = torch.from_numpy(-cost)
    r, p = cuda_auction.auction_solve_large(
        benefit, torch.from_numpy(np.array(price)), eps_list,
        kw["max_sweeps"])
    r = torch.where(r < 0, torch.argmax(benefit - p[:, None], -1), r)
    np.testing.assert_array_equal(r.numpy(), r_ref)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sweeps", [200, 3], ids=["converged", "bound"])
def test_large_plain_stats(sweeps):
    """Its stats (sweeps run, rows that bid, per element and phase) are the
    resident plain version's, the counts the kernel writes on the card."""
    cost = np.random.RandomState(35).rand(3, 40, 50).astype(np.float32)
    benefit, price = torch.from_numpy(-cost), torch.zeros((3, 50))
    eps_list = (1e-2, 1e-3)
    r, p, stats = cuda_auction.auction_solve_large(benefit, price, eps_list,
                                                   sweeps, return_stats=True)
    r2, p2, stats2 = cuda_auction.auction_solve_resident_plain(
        benefit, price, eps_list, sweeps, return_stats=True)
    assert torch.equal(r, r2) and torch.equal(p, p2)
    assert torch.equal(stats, stats2)
    assert stats.shape == (3, 2, 2) and stats.dtype == torch.int32
    assert (stats[..., 0] >= 1).all() and (stats[..., 0] <= sweeps).all()
    assert (stats[..., 1] >= 40).all()
    assert ((r < 0).any()) == (sweeps == 3)


def test_large_wrapper_checks_inputs():
    with pytest.raises(ValueError):  # N > M
        cuda_auction.auction_solve_large(
            torch.zeros((1, 8, 4)), torch.zeros((1, 4)), (1e-3,), 10)
    with pytest.raises(ValueError):  # nine epsilon phases
        cuda_auction.auction_solve_large(
            torch.zeros((1, 4, 8)), torch.zeros((1, 8)), (1e-3,) * 9, 10)
    with pytest.raises(ValueError):  # prices of another width
        cuda_auction.auction_solve_large(
            torch.zeros((1, 4, 8)), torch.zeros((1, 7)), (1e-3,), 10)


def test_large_available_by_device_and_size():
    """On the CPU never (every size past 2048^2 sweeps, as in the JAX
    package); on a CUDA device past 2048^2 with N <= M while the state fits
    a block's shared memory (decided from the device's type: no card is
    needed to ask)."""
    cuda = torch.device("cuda")
    inside = ((4096, 4096), (2100, 2101), (3000, 12000), (2100, 2200))
    for n, m in inside:
        assert cuda_auction.large_available(n, m, cuda), (n, m)
        assert cuda_auction.large_available(n, m, "cuda:0"), (n, m)
        assert not cuda_auction.large_available(n, m, "cpu"), (n, m)
        assert not cuda_auction.large_available(n, m), (n, m)
    outside = ((2048, 2048), (1024, 4096), (1, 2048 ** 2), (4096, 2048),
               (2100, 14500), (5000, 14000))
    for n, m in outside:
        assert not cuda_auction.large_available(n, m, cuda), (n, m)


def test_auction_lap_takes_the_large_kernel_on_the_card(monkeypatch):
    """With large_available true (as on the card), auction_lap solves a LAP
    past 2048^2 with one launch of auction_solve_large, and still sweeps
    under use_resident=False; the windows below 2048^2 keep their kernels."""
    from reart_tpu_torch.ops import assignment

    calls = []

    def spy(name):
        def solve(benefit, price, *_):
            calls.append(name)
            return torch.zeros(benefit.shape[:2], dtype=torch.int64), price
        return solve

    monkeypatch.setattr(assignment, "large_available", lambda n, m, d: True)
    monkeypatch.setattr(assignment, "auction_solve_resident", spy("resident"))
    monkeypatch.setattr(assignment, "auction_solve_resident_hbm",
                        spy("streamed"))
    monkeypatch.setattr(assignment, "auction_solve_large", spy("large"))
    monkeypatch.setattr(assignment, "_auction_phase", spy("sweeps"))
    kw = dict(num_scales=2, max_sweeps=2)
    past = torch.zeros((1, 1, 2048 ** 2 + 1))
    auction_lap(past, **kw)
    auction_lap(past, use_resident=False, **kw)
    auction_lap(torch.rand((1, 8, 8)), **kw)
    auction_lap(torch.rand((1, 100, 10500)), **kw)
    assert calls == ["large", "sweeps", "sweeps", "resident", "streamed"]
