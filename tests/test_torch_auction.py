"""Port parity: the dense auction LAP (reart_tpu_torch.ops.assignment and
the plain version of csrc/auction.cu) against the JAX package's auction_lap,
through its jnp phase loop and through the resident Pallas kernel in
interpret mode (the cases of tests/test_assignment.py). row_to_col must be
equal; prices within rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops.assignment import assignment_cost as jax_assignment_cost
from reart_tpu.ops.assignment import auction_lap as jax_auction_lap
from reart_tpu_torch.ops import cuda_auction
from reart_tpu_torch.ops.assignment import assignment_cost, auction_lap


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


def _port_lap(cost, price=None, **kw):
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
