"""The frozen yardstick: the kernel bounds of PERF.md's kernel table, the
trace reduction, and the seeds."""

import pytest

from yardstick import roofline, seeds, synth
from yardstick.trace import Trace


@pytest.mark.parametrize("kernel", ["nn1_bidir_coords", "blend3"])
def test_the_neighbour_kernels_bound_at_the_fits_shape(kernel):
    # PERF.md's kernel table, rows 5 and 6: 0.01803 ms by operations at
    # (9, 4096, 4096), 8 FLOP a pair at 67 TFLOP/s
    flops, nbytes = {"nn1_bidir_coords": roofline.nn1_bidir_coords_cost,
                     "blend3": roofline.blend3_cost}[kernel](9, 4096, 4096)
    b = roofline.bound_of(flops, nbytes)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 5) == 0.01803
    assert roofline.kernel_bound_ms(kernel, 9, 4096, 4096) == b["bound_ms"]


def test_a_byte_bound_kernel():
    # PERF.md's row 7 (row_top2, one pass over a (9, 4096, 4096) benefit):
    # 0.18051 ms by bytes; the benefit read once and the prices read, the
    # two best values and the best column written
    nbytes = 4 * 9 * 4096 * 4096 + 4 * 9 * 4096 + (4 + 4 + 8) * 9 * 4096
    b = roofline.bound_of(0, nbytes)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 4) == 0.1805


def test_busy_time_is_the_union_and_gaps_are_named():
    tr = Trace(window_s=1e-5, busy_s=0.0,
               device_ops=[("k1", 0.0, 4.0), ("k2", 2.0, 4.0),
                           ("k3", 8.0, 1.0)],
               host_ops=[("aten::mm", 5.0, 3.0, 1),
                         ("aten::outer", 4.0, 5.0, 1)],
               window=(0.0, 10.0), wall_s=1e-5)
    assert tr.by_name() == pytest.approx({"k1": 4e-6, "k2": 4e-6,
                                          "k3": 1e-6})
    gaps = tr.idle_gaps()
    # gaps (6, 8) inside aten::mm, nested in aten::outer; (9, 10) in none
    assert gaps == pytest.approx({"aten::mm": 2e-6,
                                  "(python between operators)": 1e-6})


def test_seeds_take_any_whole_number_and_repeat():
    for s in (0, 7, 2 ** 31 + 5, 2 ** 40, -3):
        a = seeds.derive(s, "weights", 1)
        assert a == seeds.derive(s, "weights", 1)
        assert 0 <= a < 2 ** 32
    assert seeds.derive(1, "a") != seeds.derive(2, "a")


def test_the_inputs_repeat_from_the_seed():
    cfg = {"n_frames": 3, "num_points": 60,
           "data": {"generator": "robot_table", "n_parts": 6}}
    a, b = synth.fit_inputs(cfg, 4), synth.fit_inputs(cfg, 4)
    for k in a:
        assert (a[k] == b[k]).all()
    assert a["frames"].shape == (2, 60, 3) and a["anchors"].shape == (2, 60, 3)
