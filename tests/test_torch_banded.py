"""Port parity: the banded points-level LAP (reart_tpu_torch.ops.assignment's
banded part and the plain version of csrc/auction_banded.cu) against the JAX
package, whose Pallas kernel runs in interpret mode as
tests/test_assignment.py runs it.

Curve keys and sort permutations must be equal bit for bit, the sizing
helpers equal; the banded solve's row_to_col equal and its prices within
rtol 1e-6; `auction_lap_points` equal in the original index space, its
prices within rtol 1e-6, atol 1e-6: XLA:CPU contracts the interpreted
band's products into FMAs (7019 of 65536 band values of one element differ
by an ulp from the uncontracted formula), which moves prices made of
values near 1 by up to 4.8e-7 (ROADMAP.md section 3); the overflow
fraction equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reart_tpu.ops import assignment as JA
from reart_tpu.ops import pallas_auction as JP
from reart_tpu_torch.ops import assignment as A
from reart_tpu_torch.ops import cuda_auction as C

torch.set_num_threads(1)


def _clouds(seed, b, n, noise=0.05):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, 3).astype(np.float32)
    tgt = (src + noise * rng.randn(b, n, 3)).astype(np.float32)
    return src, tgt


@pytest.mark.parametrize("kind", ["random", "edges", "flat"])
def test_curve_keys_equal_jax(kind):
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 300, 3).astype(np.float32)
    if kind == "edges":  # points on the bounding box's faces and corners
        pts[:, :8] = np.float32([[x, y, z] for x in (-3, 3) for y in (-3, 3)
                                 for z in (-3, 3)])
        pts[:, 8:40, 0] = 3.0
        pts[:, 40:70, 2] = -3.0
    elif kind == "flat":  # a degenerate extent: every z equal
        pts[..., 2] = 0.25
    lo, hi = pts.min(1, keepdims=True), pts.max(1, keepdims=True)
    tp, tlo, thi = (torch.from_numpy(x) for x in (pts, lo, hi))
    for jfn, tfn in ((JA._morton_keys, A._morton_keys),
                     (JA._hilbert_keys, A._hilbert_keys)):
        want = np.asarray(jfn(jnp.asarray(pts), jnp.asarray(lo),
                              jnp.asarray(hi))).astype(np.int64)
        np.testing.assert_array_equal(tfn(tp, tlo, thi).numpy(), want)
    cells = rng.randint(0, 1024, (500, 3))
    np.testing.assert_array_equal(
        A._hilbert_index(torch.from_numpy(cells)).numpy(),
        np.asarray(JA._hilbert_index(jnp.asarray(cells, jnp.uint32))))


@pytest.mark.parametrize("band,curve", [(128, None), (1024, None),
                                        (512, "hilbert"), (512, "morton")])
def test_curve_sort_equal_jax(band, curve):
    src, tgt = _clouds(1, 2, 256)
    src[:, 10:20] = src[:, :1]  # duplicates: ties sorted by index
    j = JA._curve_sort(jnp.asarray(src), jnp.asarray(tgt), band, curve)
    t = A._curve_sort(torch.from_numpy(src), torch.from_numpy(tgt), band,
                      curve)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sizing_helpers_equal_jax():
    for n in (8, 64, 1000, 1024, 1152, 2048, 4096, 8192, 16384, 32768):
        assert A.resolve_band(-1, n) == JA.resolve_band(-1, n)
        assert A.resolve_band(384, n) == JA.resolve_band(384, n) == 384
        assert C.band_tile(n) == JP.band_tile(n)
    for n, w, tile in [(64, 64, 8), (128, 128, 16), (2048, 512, 256),
                       (4096, 1024, 256), (1152, 512, 144), (256, 128, 32),
                       (96, 40, 8)]:
        assert C._band_offsets(n, n, w, tile) == JP._band_offsets(n, n, w,
                                                                  tile)


def _jax_banded(src, tgt, price, **kw):
    with pltpu.force_tpu_interpret_mode():
        r2c, p = JP.auction_solve_banded(
            jnp.asarray(src), jnp.transpose(jnp.asarray(tgt), (0, 2, 1)),
            jnp.asarray(price), **kw)
    return np.asarray(r2c), np.asarray(p)


# the problems of tests/test_assignment.py::TestBandedAuction
@pytest.mark.parametrize("b,n,w,tile,eps,sweeps,seed", [
    (2, 64, 64, 8, (5e-3, 1e-4), 2000, 3),
    (2, 64, 64, 8, (1e-2, 1e-3, 1e-4), 2000, 11),
    (3, 128, 128, 16, (5e-3, 1e-4), 150, 5),
    (2, 128, 32, 16, (5e-3, 1e-4), 20, 7),     # narrow band, sweep bound
])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_banded_plain_matches_pallas(b, n, w, tile, eps, sweeps, seed, carry,
                                     warm):
    src, tgt = _clouds(seed, b, n, 0.03)
    price = (np.random.RandomState(seed + 1).rand(b, n).astype(np.float32)
             * 0.05 if warm else np.zeros((b, n), np.float32))
    kw = dict(eps_list=eps, max_sweeps=sweeps, w=w, tile=tile, carry=carry)
    jr, jp = _jax_banded(src, tgt, price, **kw)
    tr, tp = C.auction_solve_banded(torch.from_numpy(src),
                                    torch.from_numpy(tgt),
                                    torch.from_numpy(price), **kw)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6)


def test_banded_stats_and_bound():
    """The plain version's stats: sweeps per phase within the bound, every
    row and tile bidding in a phase's first sweep, a converged phase
    carried into the next bidding nothing; one sweep leaves rows to the
    in-band fallback."""
    src, tgt = _clouds(2, 2, 128, 0.03)
    args = (torch.from_numpy(src), torch.from_numpy(tgt))
    zero = torch.zeros(2, 128)
    r, p, st = C.auction_solve_banded_plain(*args, zero, (5e-3, 1e-4), 500,
                                            64, 16, return_stats=True)
    assert st.shape == (2, 2, 3) and (st[..., 0] <= 500).all()
    assert (st[..., 0] >= 1).all()
    assert (st[..., 1] >= 128).all() and (st[..., 2] >= 8).all()
    assert len(np.unique(r[0].numpy())) == 128  # converged: a permutation
    _, _, st2 = C.auction_solve_banded_plain(*args, p, (1e-4, 1e-4), 500, 64,
                                             16, carry=True, return_stats=True)
    assert (st2[:, 1] == 0).all()  # nothing violates eps-CS: no sweep
    src, tgt = _clouds(3, 2, 128, 1.0)  # unrelated clouds: bidding wars
    r1, _ = C.auction_solve_banded_plain(torch.from_numpy(src),
                                         torch.from_numpy(tgt), zero,
                                         (1e-4,), 1, 64, 16)
    jr, _ = _jax_banded(src, tgt, zero.numpy(), eps_list=(1e-4,),
                        max_sweeps=1, w=64, tile=16)
    np.testing.assert_array_equal(r1.numpy(), jr)
    assert len(np.unique(r1[0].numpy())) < 128  # fallback rows repeat


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("nn_recenter", [False, True])
@pytest.mark.parametrize("curve", [None, "hilbert"])
def test_auction_lap_points_matches_jax(warm, nn_recenter, curve):
    src, tgt = _clouds(4, 2, 256)
    perm = np.random.RandomState(5).permutation(256)
    tgt = tgt[:, perm]  # the match of row i sits at column inv[i]
    price = (np.random.RandomState(6).rand(2, 256).astype(np.float32) * 0.02
             if warm else None)
    kw = dict(band=128, max_sweeps=200, nn_recenter=nn_recenter, curve=curve,
              return_price=True)
    with pltpu.force_tpu_interpret_mode():
        jr, jp = JA.auction_lap_points(
            jnp.asarray(src), jnp.asarray(tgt),
            price=None if price is None else jnp.asarray(price), **kw)
    tr, tp = A.auction_lap_points(
        torch.from_numpy(src), torch.from_numpy(tgt),
        price=None if price is None else torch.from_numpy(price), **kw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    inv = np.argsort(perm)
    assert (tr[0].numpy() == inv).mean() > 0.9  # original index space


@pytest.mark.parametrize("band,curve", [(128, None), (512, "hilbert")])
def test_band_overflow_fraction_matches_jax(band, curve):
    rng = np.random.RandomState(0)
    cano = rng.randn(1, 1024, 3).astype(np.float32)
    a = 0.5
    rot = np.float32([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]])
    for tgt in (cano + 1e-3, cano @ rot.T, cano * np.float32([-1, 1, 1])):
        tgt = tgt.astype(np.float32)
        want = float(JA.band_overflow_fraction(jnp.asarray(cano),
                                               jnp.asarray(tgt), band, curve))
        got = float(A.band_overflow_fraction(torch.from_numpy(cano),
                                             torch.from_numpy(tgt), band,
                                             curve))
        assert got == want and 0.0 <= got <= 1.0


def test_banded_availability():
    # the cases of tests/test_assignment.py::TestBandedAuction::test_gating
    for n, m, band in [(1024, 1024, 512), (2048, 2048, 0), (2048, 1024, 512)]:
        assert not A.banded_points_available(n, m, band, "cuda")
        assert not JA.banded_points_available(n, m, band)
    # a window that is unaligned, too wide, or a band past 16 MB
    for n, w in [(2048, 500), (2048, 2048), (8192, 1024)]:
        assert not A.banded_points_available(n, n, w, "cuda")
    # the sapien and robot giant problems take the band on the card only
    for n in (2048, 4096):
        band = A.resolve_band(-1, n)
        assert A.banded_points_available(n, n, band, "cuda")
        assert A.banded_points_available(n, n, band, torch.device("cuda", 0))
        assert not A.banded_points_available(n, n, band, "cpu")
        assert not A.banded_points_available(n, n, band)
    with pytest.raises(ValueError, match="tile dividing N"):
        C.auction_solve_banded(torch.zeros(1, 100, 3), torch.zeros(1, 100, 3),
                               torch.zeros(1, 100), (1e-3,), 10, 64, tile=16)
